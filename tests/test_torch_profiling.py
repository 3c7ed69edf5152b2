"""The port's profiling helpers against the JAX package's, on the CPU:
``StepTimer`` on the same clock readings, ``timed``'s contract (result,
seconds per call, warm-up not timed, a synchronize per call), and
``trace`` / ``annotate`` writing a Chrome trace that holds the range."""

import json
import time
from unittest import mock

import numpy as np
import pytest
import torch

from avatar_tpu.utils import profiling as jprof
from avatar_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("window", [1, 3, 50])
def test_step_timer_matches_jax(window):
    clock = iter(np.cumsum(np.random.default_rng(window).uniform(0.01, 0.5, 12)).tolist())
    readings = list(clock)
    got = {}
    for name, mod in (("j", jprof), ("t", tprof)):
        ticks = iter(readings)
        with mock.patch.object(time, "perf_counter", lambda: next(ticks)):
            timer = mod.StepTimer(window=window)
            assert timer.mean_step_time is None and timer.throughput(8) is None
            got[name] = ([timer.tick() for _ in range(len(readings))],
                         timer.mean_step_time, timer.throughput(8))
    assert got["t"] == got["j"]


def test_timed_counts_calls_and_synchronizes_cuda_results():
    calls = []

    def fn(a, scale=1.0):
        calls.append(a)
        return {"out": [torch.full((2,), a * scale)], "n": a}

    result, seconds = tprof.timed(fn, 3, scale=2.0, iters=4, warmup=2)
    assert len(calls) == 6 and seconds >= 0.0
    assert result["out"][0].tolist() == [6.0, 6.0]
    jres, _ = jprof.timed(lambda a: np.full((2,), a * 2.0), 3, iters=4, warmup=2)
    np.testing.assert_array_equal(result["out"][0].numpy(), jres)
    # a result on the card is synchronized on each device it lives on
    fake = mock.Mock(spec=torch.Tensor)
    fake.device = torch.device("cuda", 1)
    with mock.patch.object(tprof.torch.cuda, "synchronize") as sync:
        tprof.timed(lambda: (fake, [fake], {"x": torch.zeros(1)}), iters=2, warmup=1)
    assert [c.args for c in sync.call_args_list] == [(torch.device("cuda", 1),)] * 3


def test_trace_writes_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.annotate("encode"):
            (x @ x).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert [str(f) for f in files] == [prof.trace_path]
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "encode" in names and any(n and "mm" in n for n in names)
    assert "encode" in {e.key for e in prof.key_averages()}
