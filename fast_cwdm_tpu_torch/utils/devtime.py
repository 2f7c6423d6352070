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

# launch counter of a wrapper of the port (``ops.launch_counts``) → the
# kernel it launches once a count, by substrings of its name in the trace;
# both widths of the wgmma kernel are the symbol ``conv3d_wgmma_kernel``
PORT_KERNELS = {
    "haar_dwt3": ("haar_dwt3_kernel",),
    "haar_idwt3": ("haar_idwt3_kernel",),
    "affine_silu": ("affine_silu_kernel",),
    "affine_silu_bwd": ("affine_silu_bwd_reduce",),
    "gn_stats": ("gn_stats_kernel",),
    "conv3d_wgmma": ("conv3d_wgmma_kernel",),
    "conv3d_wgmma_n32": ("conv3d_wgmma_kernel",),
    "conv3d_splitk": ("conv3d_splitk_kernel",),
    "conv3d_wgmma_tf32": ("conv3d_tf32_kernel",),
    "conv3d_mma_sync": ("conv3d_bf16_kernel", "conv3d_f32_kernel"),
}


def missing_records(launched: dict[str, int], records: dict[str, int]) -> dict[str, list]:
    """Counter → ``[records, launches]`` where the trace's ``records`` (count
    by kernel name) hold fewer of the counter's kernel than ``launched``
    (counter → launches, ``ops.launches_since``) says ran. Counters that
    share a kernel are summed, under the names of those that launched
    joined by ``+``."""
    by_kernel: dict[tuple, list] = {}
    for counter, names in PORT_KERNELS.items():
        entry = by_kernel.setdefault(names, [[], 0])
        if launched.get(counter, 0):
            entry[0].append(counter)
            entry[1] += launched[counter]
    out = {}
    for names, (counters, n) in by_kernel.items():
        got = sum(c for k, c in records.items() if any(s in k for s in names))
        if got < n:
            out["+".join(counters)] = [got, n]
    return out


def _spun_events_ms(fn, args, iters: int, host_ms: float) -> float:
    """CUDA-event ms per call of ``iters`` calls enqueued behind a spin of
    the card that outlasts their enqueue (~2e6 cycles a millisecond at the
    card's clock): the kernels run back to back, so the events time the
    card, not the host's launches."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(int(min(2e9, 3e6 * (host_ms + 1.0))))
    events[0].record()
    for _ in range(iters):
        fn(*args)
    events[1].record()
    torch.cuda.synchronize()
    return events[0].elapsed_time(events[1]) / iters


def devtime(fn, *args, iters: int = 3, detail: bool = False, events: bool = False) -> dict:
    """Run ``fn(*args)`` once to warm up, then ``iters`` times under the
    profiler, synchronised before and after, and return per iteration:

    - ``total_ms``: the summed device time of the kernels and copies;
    - ``wall_ms``: the host-clock time of one traced call;
    - ``busy_share``: ``total_ms / wall_ms``;
    - with ``detail``, ``ops``: device ms by kernel name, largest first.

    On a CUDA device also ``events_ms``, the CUDA-event time of one traced
    call (first launch to last completion, host gaps included);
    ``records_missing``, each launch counter of the port's wrappers (see
    :data:`PORT_KERNELS`) whose kernel has fewer records in the trace than
    the wrapper launched in the traced calls, as ``[records, launches]``;
    and ``source``: ``"profiler"``, or ``"cuda_events"`` where the trace
    holds no kernel at all or misses records (CUPTI has been seen to deliver
    no records for whole short windows on the H100 host, and only some of
    them for the kernels of the port's ctypes libraries). ``total_ms`` is
    then the CUDA-event time of ``iters`` more calls enqueued behind a spin
    of the card, so that their kernels run back to back as the host's
    launches wait in the queue.
    A kernel replayed from a CUDA graph moves no counter, so its records
    are not checked. ``events=True`` times that way without the profiler:
    the reliable device time of a call of one or a few kernels. Without a
    CUDA device nothing runs on a device, so ``total_ms`` and ``busy_share``
    are 0.0 (as the JAX package's ``devtime`` gives 0.0 where there is no
    TPU plane).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fast_cwdm_tpu_torch.ops import launch_counts, launches_since

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn(*args)
    sync()
    if events and cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        total = _spun_events_ms(fn, args, iters, wall_ms * iters)
        return {"total_ms": total, "wall_ms": wall_ms, "events_ms": total,
                "source": "cuda_events", "busy_share": total / wall_ms if wall_ms else 0.0}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else []
    before = launch_counts()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        if cuda:
            marks[0].record()
        for _ in range(iters):
            fn(*args)
        if cuda:
            marks[1].record()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    launched = launches_since(before)
    ops: dict[str, float] = {}
    records: dict[str, int] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "device_time_total", 0)
        ops[e.key] = ops.get(e.key, 0.0) + us / 1e3 / iters
        records[e.key] = records.get(e.key, 0) + e.count
    total = sum(ops.values())
    out = {"total_ms": total, "wall_ms": wall_ms}
    if cuda:
        out["events_ms"] = marks[0].elapsed_time(marks[1]) / iters
        out["records_missing"] = missing_records(launched, records)
        out["source"] = "profiler" if total and not out["records_missing"] else "cuda_events"
        if out["source"] == "cuda_events":
            out["total_ms"] = total = _spun_events_ms(fn, args, iters, wall_ms * iters)
    out["busy_share"] = total / wall_ms if wall_ms else 0.0
    if detail:
        out["ops"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return out
