"""Profiling and tracing (port of ``fast_cwdm_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace (a Chrome/Perfetto JSON file),
  taken only where a log directory is given or ``FAST_CWDM_TRACE_DIR`` is
  set, so production runs pay nothing;
- :func:`annotate`: a named region of the trace's timeline;
- :class:`StepTimer`: wall-clock phase accumulators that print the
  reference's ``[PROFILE]`` line.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


def annotate(name: str):
    """Named region for the profiler timeline."""
    return torch.profiler.record_function(name)


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
