"""The one traffic generator: what a mix file's parameters turn into, from
``--seed``.

Every seed gets the same work in another order: an open loop's arrival
count is fixed by its rate and the window, and its gaps are one fixed set
of exponential quantiles in a seeded order; caption lengths are spread evenly
over their range and shuffled, and each request's own seed comes from the
run's. Only the avatar drawn for a request (Zipf over a pool) and the
frames of its pose sequence vary freely.
"""

from __future__ import annotations

import hashlib

import numpy as np


def sub_seed(seed: int, *labels) -> int:
    """A 62-bit seed of ``seed`` and ``labels``, the same on every machine."""
    text = ":".join(str(x) for x in (seed, *labels)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 2


def rng(seed: int, *labels) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *labels))


def poisson_schedule(seed: int, rate_per_s: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of ``round(rate * seconds)`` arrivals whose
    gaps are the exponential distribution's quantiles at (i + 1/2) / n,
    mean 1 / rate, in an order drawn from the seed and scaled to end
    inside the window: every seed gets the same gaps, in another order."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate_per_s
    gaps = rng(seed, "arrivals").permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    span = due[-1] + gaps[-1]
    return due * min(1.0, seconds / span) if span > 0 else due


def caption_lengths(seed: int, n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` kept-token counts spread evenly over [lo, hi], shuffled."""
    even = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    return rng(seed, "captions").permutation(even)


def zipf_choice(seed: int, n: int, pool: int, s: float) -> np.ndarray:
    """``n`` draws from {0 .. pool - 1} with P(k) proportional to 1 / (k + 1)^s."""
    p = 1.0 / np.arange(1, pool + 1) ** s
    return rng(seed, "avatars").choice(pool, size=n, p=p / p.sum())


def request_seeds(seed: int, n: int) -> list:
    return [sub_seed(seed, "request", i) for i in range(n)]
