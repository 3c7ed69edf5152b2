"""Profiling, tracing and timing (port of ``avatar_tpu/utils/profiling.py``).

- ``annotate(name)``: the program's span. Off (the default) it is one
  shared no-op context. Inside :func:`recording` it times its block on
  ``time.perf_counter_ns()`` into the recording, as a range of a running
  ``torch.profiler`` session, and as an NVTX range where CUDA is up;
- ``annotated(name)``: a decorator that runs each call of a function in
  span ``name``;
- ``recording()``: turns the tracer on for its block and yields a
  :class:`Recording`: the spans and the change of every kernel launch
  counter of ``ops/`` over the block. One recording is open at a time;
- ``trace(dir)``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA, under :func:`recording`; on exit a Chrome / Perfetto trace
  file in ``dir`` (ui.perfetto.dev or chrome://tracing read it) that holds
  every span of the block;
- ``timed(fn)``: wall-clock seconds per call, each call ending in a
  synchronize of every device its result's tensors live on, so that the
  time covers the work and not only its launch;
- ``StepTimer``: a rolling step-time and throughput meter for train loops.

The tracer adds no synchronize: a span's time is the host's, from the
call's start to its return, launches included and device work not waited
for (so also any wait for room in a full launch queue). The program's op
spans, ``attn.*``, ``int8.*``, ``conv.*`` and ``gemm.*`` (each call of a
kernel wrapper or library product, the copies it makes included), are
innermost: no span opens inside one.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One closed span: ``parent`` is the index in :attr:`Recording.spans`
    of the span that was open around it on the same thread (None at the
    top of the recording); times are ``time.perf_counter_ns()``."""

    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: int


_rec: Optional["Recording"] = None  # the open recording; None: the tracer is off
_nvtx = False
_local = threading.local()  # each thread's stack of open spans
# A span's range in a running profiler session: torch's C++ range (the one
# of its compiled-region marks). On an H100's host it costs 0.6 us a span
# in a CUDA-only session and 2.2 us in a CPU + CUDA one.
_range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The shared no-op span. Its ``__enter__`` and ``__exit__`` are
    ``object.__init__``, a C slot that takes and ignores the exit's three
    arguments (a class with its own ``__new__`` and no ``__init__`` lets it)
    and returns None: half the cost of Python-level methods, and an
    exception passes through."""

    __slots__ = ()

    def __new__(cls):
        return object.__new__(cls)

    __enter__ = object.__init__
    __exit__ = object.__init__


_OFF = _Off()


class _On:
    __slots__ = ("name", "parent", "start", "end", "child_ns", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.child_ns = 0
        stack.append(self)
        # a profiler session shows the span on its own clock; without one
        # the range would cost its call for nothing
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = _range(self.name)
            self.rf.__enter__()
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end - self.start
        rec = _rec
        if rec is not None:
            rec._spans.append(self)
        return False


def annotate(name: str):
    """The program's span ``name`` around a ``with`` block: a no-op unless
    a :func:`recording` is open (then see the module's docstring)."""
    if _rec is None:
        return _OFF
    return _On(name)


def annotated(name: str):
    """Decorator: every call of the function in span ``name``. Off, the
    call costs one more frame and the flag test."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _rec is None:
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def _launch_counts() -> Dict[str, int]:
    """Every kernel launch counter of ``ops/``, by name."""
    from avatar_tpu_torch.ops import causal_conv3d, flash_attention, int8_matmul

    return {**flash_attention.launch_counts, **int8_matmul.launch_counts,
            **causal_conv3d.launch_counts}


class Recording:
    """What one :func:`recording` block held: its spans (:attr:`spans`)
    and ``launches`` (each kernel launch counter of ``ops/`` that changed,
    by its change)."""

    def __init__(self):
        self._spans: List[_On] = []  # in the order they closed
        self._launches_at = _launch_counts()
        self.launches: Dict[str, int] = {}

    def _close(self) -> None:
        before = self._launches_at
        self.launches = {k: v - before.get(k, 0) for k, v in _launch_counts().items()
                         if v != before.get(k, 0)}

    @property
    def spans(self) -> List[Span]:
        """The block's spans in the order they closed (a child before its
        parent)."""
        index = {id(s): i for i, s in enumerate(self._spans)}
        return [Span(s.name, None if s.parent is None else index.get(id(s.parent)),
                     s.start, s.end) for s in self._spans]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Span name -> {"n": calls, "host_s": host seconds in total,
        "self_s": host seconds less those of its child spans}."""
        rows: Dict[str, list] = {}
        for s in self._spans:
            row = rows.get(s.name)
            if row is None:
                row = rows[s.name] = [0, 0, 0]
            host = s.end - s.start
            row[0] += 1
            row[1] += host
            row[2] += host - s.child_ns
        return {name: {"n": n, "host_s": host * 1e-9, "self_s": own * 1e-9}
                for name, (n, host, own) in rows.items()}

    def flat(self) -> Dict[str, float]:
        """The recording as floats under flat keys: ``<span>.host_s``,
        ``<span>.self_s`` and ``<span>.n`` for each span name,
        ``launches.<name>`` for each launch counter that changed."""
        out = {f"{name}.{key}": float(v)
               for name, row in self.summary().items() for key, v in row.items()}
        out.update({f"launches.{k}": float(v) for k, v in self.launches.items()})
        return out


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turns the tracer on for the block; yields its :class:`Recording`,
    filled when the block ends. Recordings do not nest: opening one inside
    another raises RuntimeError."""
    global _rec, _nvtx
    if _rec is not None:
        raise RuntimeError("a recording is already open; recordings do not nest")
    _nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    rec = _rec = Recording()
    try:
        yield rec
    finally:
        _rec = None
        rec._close()


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[object]:
    """Profile the block under :func:`recording`; write
    ``trace_<pid>_<ns>.json`` into ``log_dir``. Yields the
    ``torch.profiler.profile`` (its ``key_averages()`` are there after the
    block, and the block's :class:`Recording` as its ``recording``).
    ``create_perfetto_link``: print the file's path to open in
    ui.perfetto.dev (the trace is not uploaded anywhere)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        with recording() as rec:
            yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.recording = rec
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path
        if create_perfetto_link:
            print(f"trace written to {path}: open it in https://ui.perfetto.dev")


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
