"""Device time of a callable from ``torch.profiler`` (port of
``fast_cwdm_tpu/utils/devtime.py``).

A host clock around an asynchronous launch measures the enqueue, and a
host clock around a synchronised call measures the host's launch overhead
too. The device's own kernel events say how long the card worked:

    from fast_cwdm_tpu_torch.utils.devtime import devtime
    ms = devtime(fn, *args)["total_ms"]

Beside the device time, the result gives the host-clock wall time of the
traced calls and their ratio, the busy share: the fraction of the wall
time the card spent in kernels.
"""

from __future__ import annotations

import time

import torch

__all__ = ["devtime"]


def devtime(fn, *args, iters: int = 3, detail: bool = False) -> dict:
    """Run ``fn(*args)`` once to warm up, then ``iters`` times under the
    profiler, synchronised before and after, and return per iteration:

    - ``total_ms``: the summed device time of the kernels and copies;
    - ``wall_ms``: the host-clock time of one traced call;
    - ``busy_share``: ``total_ms / wall_ms``;
    - with ``detail``, ``ops``: device ms by kernel name, largest first.

    Without a CUDA device nothing runs on a device, so ``total_ms`` and
    ``busy_share`` are 0.0 (as the JAX package's ``devtime`` gives 0.0
    where there is no TPU plane).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn(*args)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    ops: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "device_time_total", 0)
        ops[e.key] = ops.get(e.key, 0.0) + us / 1e3 / iters
    total = sum(ops.values())
    out = {"total_ms": total, "wall_ms": wall_ms,
           "busy_share": total / wall_ms if wall_ms else 0.0}
    if detail:
        out["ops"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return out
