"""What the drivers share: the program's set-up for a configuration, the
device trace of a traced run, and the record a run hands to the metric
readers."""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from benchmark import weights


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclass
class Ctx:
    """One run: the cell, its configuration file and mix file (as dicts),
    the run's arguments, and the limits of its check."""

    cell: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0  # process start, on time.perf_counter()


@dataclass
class Record:
    """What a driver measured; the metric readers take their numbers from
    it. Times are ``time.perf_counter()`` seconds."""

    ctx: Ctx
    setup_s: float = 0.0
    window_start: float = 0.0
    attempted: int = 0
    failed: int = 0
    latencies: List[float] = field(default_factory=list)  # inf: failed
    done: List[tuple] = field(default_factory=list)  # (end, units) of finished work
    units_end: float = 0.0  # end of the last piece of work started in the window
    peak_mem_bytes: int = 0
    memory_peak_bytes: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Optional["DeviceTrace"] = None
    work: Any = None  # work.Work of the traced piece
    checks: List[tuple] = field(default_factory=list)  # (name, value, limit)

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


def build_kernels(device: str) -> float:
    """Builds (first run in a checkout) or loads the program's CUDA
    libraries; seconds taken."""
    if device != "cuda":
        return 0.0
    from avatar_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    kernel_build.build_all(kernel_build.KERNEL_SOURCES)
    return time.perf_counter() - t0


def quantized(config: dict) -> dict:
    """The configuration's W8A8 settings ({} for none)."""
    return config.get("quantize") or {}


def make_pipeline(ctx: Ctx):
    """(pipeline, dit tree, DiTConfig, vae tree, VAEConfig): the program's
    pipeline over the benchmark's weights, quantized as the configuration
    says."""
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    import torch

    dcfg, dit, vcfg, vae = weights.make_models(ctx.config["dit"], ctx.config["vae"], ctx.seed,
                                               ctx.device, getattr(torch, ctx.config["dtype"]))
    q = quantized(ctx.config)
    pipe = LTXVideoPipeline(dcfg, dit, vcfg, vae, quantize_weights=q.get("dit") or False,
                            quantize_vae=q.get("vae") or False, device=ctx.device)
    return pipe, dit, dcfg, vae, vcfg


def reference_precision(config: dict, mode: Optional[str] = None):
    """The plain reference's :class:`Precision` for the configuration (or
    ``mode``, a control's)."""
    from benchmark.reference.ltxv import Precision

    q = quantized(config)
    base = "w8a8" if q else "f32"
    return Precision(mode or base, dit_int8=q.get("dit") == "w8a8",
                     vae_int8_min=q.get("vae_min_weight_elements") if q.get("vae") else None)


def free_program(*objs) -> None:
    """Drops the program's state and returns its memory to the device."""
    import gc

    import torch

    for o in objs:
        del o
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Device trace
# ---------------------------------------------------------------------------


class DeviceTrace:
    """The device operations of one ``torch.profiler`` session: their
    names, counts and device seconds, the busy time (the union of their
    intervals) and the session's wall length."""

    def __init__(self):
        self.prof = None
        self.t0 = self.window_s = 0.0
        self.ops: Dict[str, list] = {}  # name -> [count, seconds]
        self.busy_s = 0.0
        self.gaps: List[tuple] = []

    @staticmethod
    def warm() -> None:
        """Loads the profiler's device tracing once, in set-up: the first
        session of a process pays seconds for it."""
        import torch
        from torch.profiler import ProfilerActivity

        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self, sync: bool = True) -> None:
        """Starts the session; ``sync`` first drains the device (a serving
        run's sender must not wait for that)."""
        import torch
        from torch.profiler import ProfilerActivity

        if sync:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, sync: bool = True) -> None:
        """Ends the session; its events are read by :meth:`analyze`."""
        import torch

        if sync:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def analyze(self) -> None:
        """Reads the session's device operations (once)."""
        from torch.autograd import DeviceType

        if self.prof is None:
            return
        spans = []
        for e in self.prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            start, end = e.time_range.start, e.time_range.end
            rec = self.ops.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += (end - start) * 1e-6
            spans.append((start, end, e.name))
        spans.sort()
        busy, cur_s, cur_e = 0.0, None, None
        for s, e, name in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    self.gaps.append(((s - cur_e) * 1e-6, f"before {name[:80]}"))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy * 1e-6
        self.prof = None

    @staticmethod
    def _is_copy(name: str) -> bool:
        return name.startswith(("Memcpy", "Memset", "[memory]"))

    def kernels(self) -> int:
        """CUDA kernels launched (copies and memsets left out)."""
        return sum(c for n, (c, _) in self.ops.items() if not self._is_copy(n))

    def seconds_matching(self, patterns) -> Optional[float]:
        """Device seconds of the operations whose name holds any of
        ``patterns``; None where none does."""
        hits = [s for n, (_, s) in self.ops.items() if any(p in n for p in patterns)]
        return sum(hits) if hits else None

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:10]
        return {"device_ops": [[n[:120], s] for n, (_, s) in top],
                "idle_gaps": [[label, s] for s, label in gaps]}


def percentile(values: List[float], q: float) -> float:
    """The ``q`` percentile (0-100) by linear interpolation between order
    statistics (numpy's default); an inf among them counts as the largest."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
