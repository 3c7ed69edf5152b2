"""Profiling and timing (port of ``avatar_tpu/utils/profiling.py``).

- ``trace(dir)``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA; on exit a Chrome / Perfetto trace file in ``dir``
  (ui.perfetto.dev or chrome://tracing read it);
- ``annotate(name)``: a named range in those traces
  (``torch.profiler.record_function``), and an NVTX range when CUDA is up;
- ``timed(fn)``: wall-clock seconds per call, each call ending in a
  synchronize of every device its result's tensors live on, so that the
  time covers the work and not only its launch;
- ``StepTimer``: a rolling step-time and throughput meter for train loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[object]:
    """Profile the block; write ``trace_<pid>_<ns>.json`` into ``log_dir``.
    Yields the ``torch.profiler.profile`` (its ``key_averages()`` are
    there after the block). ``create_perfetto_link``: print the file's path
    to open in ui.perfetto.dev (the trace is not uploaded anywhere)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path
        if create_perfetto_link:
            print(f"trace written to {path}: open it in https://ui.perfetto.dev")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in profiler traces (and in NVTX tools)."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _devices(result, found: set) -> set:
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _devices(v, found)
    return found


def _materialize(result) -> None:
    for device in _devices(result, set()):
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, iters: int = 1, warmup: int = 1, **kwargs):
    """Wall-clock ``fn``; returns (result, seconds_per_iter). Every call,
    warm-up included, ends in a synchronize of the devices that hold the
    result's tensors (a CPU result is ready when ``fn`` returns)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _materialize(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
        _materialize(result)
    return result, (time.perf_counter() - t0) / iters


class StepTimer:
    """Rolling samples/sec + step-time meter for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> Optional[float]:
        return sum(self._times) / len(self._times) if self._times else None

    def throughput(self, batch_size: int) -> Optional[float]:
        st = self.mean_step_time
        return batch_size / st if st else None
