"""Profiling and tracing (port of ``fast_cwdm_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace (a Chrome/Perfetto JSON file),
  taken only where a log directory is given or ``FAST_CWDM_TRACE_DIR`` is
  set, so production runs pay nothing;
- :func:`annotate`: the program's span, a named region of the trace's
  timeline that is also kept in memory (:func:`spans`) with its parent, its
  host interval and, on a CUDA device, its device time; on only while a
  ``torch.profiler`` session is collecting;
- :class:`StepTimer`: wall-clock phase accumulators that print the
  reference's ``[PROFILE]`` line.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

# spans kept in memory, the newest; older ones are dropped
STORE_SPANS = 16384
_store: collections.deque = collections.deque(maxlen=STORE_SPANS)
_open = threading.local()  # .stack: this thread's open spans, outermost first
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(name: str = "trace", logdir: str | None = None):
    """Trace the block into ``<logdir>/<name>/trace.json`` (``logdir``
    defaults to ``FAST_CWDM_TRACE_DIR``; neither set: no trace)."""
    logdir = logdir or os.environ.get("FAST_CWDM_TRACE_DIR")
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(logdir, name)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def annotate(name: str, **counts):
    """The span ``name`` around a ``with`` block; ``counts`` (bytes, steps,
    ...) are kept with it.

    Off, the default, whenever no ``torch.profiler`` session is collecting
    (one check, ~0.1 µs): the span is a shared no-op context that records
    nothing. On, it is a record function of the profiler (its C++ form,
    which takes its times within a microsecond of the block's), it takes the
    block's host start and end in Unix-epoch ns (``time.time_ns``, the clock
    that the profiler converts its event times to), and, where CUDA is in
    use, a pair of timing events on the current stream, none when the span
    is entered while that stream captures a CUDA graph. The events are resolved
    when :func:`spans` reads them: a span adds no synchronisation. Spans
    entered inside an open span of the same thread are its children and
    share its root."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, counts)


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "root", "start_ns", "end_ns", "_record",
                 "_events")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].root if stack else self.id
        stack.append(self)
        self._events = None
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        # the host times next to the record function's own, with nothing
        # between that allocates (a garbage collection there, ~0.1 ms,
        # would part them)
        self._record = torch._C._profiler._RecordFunctionFast(self.name)
        self._record.__enter__()
        self.start_ns = time.time_ns()

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._record.__exit__()
        if self._events is not None:
            self._events[1].record()
        _stack().pop()
        _store.append(self)
        return False


def spans() -> list[dict]:
    """The kept spans in the order they were entered, each ``{"name", "id",
    "parent" (None for a root), "root", "start_ns", "end_ns", "host_ms",
    "device_ms", "counts"}``. ``device_ms`` is the time between the span's
    two events on the device (None without events); reading it waits for
    the span's last event."""
    out = []
    for s in sorted(_store, key=lambda s: s.id):
        device_ms = None
        if s._events is not None:
            s._events[1].synchronize()
            device_ms = s._events[0].elapsed_time(s._events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
                    "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "host_ms": (s.end_ns - s.start_ns) / 1e6, "device_ms": device_ms,
                    "counts": dict(s.counts)})
    return out


def clear_spans() -> None:
    """Empty the store."""
    _store.clear()


class StepTimer:
    """Phase accumulators emitting the reference's ``[PROFILE]`` line."""

    PHASES = ("data", "step", "log", "save")

    def __init__(self):
        self.reset()

    def reset(self):
        self.acc = {p: 0.0 for p in self.PHASES}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0

    def report(self, step: int) -> str:
        total = sum(self.acc.values())
        line = (
            f"[PROFILE] Step {step}: "
            f"Data={self.acc['data']:.2f}s Step={self.acc['step']:.2f}s "
            f"Log={self.acc['log']:.2f}s Save={self.acc['save']:.2f}s "
            f"Total={total:.2f}s"
        )
        self.reset()
        return line
