"""The device's side of a traced block of work: busy time, kernels by name,
idle gaps by what the host was doing, and a check of the profiler's records
against the program's own launch counters.

The arithmetic is the benchmark's copy of the program's
``utils/devtime.py`` (``PORT_KERNELS`` and ``missing_records``): CUPTI has
been seen to deliver no records, or only some, for kernels that the
program's ctypes libraries launch. Where the trace holds fewer records of a
kernel than its counter says ran, the readers of this run that rest on
kernel records are left out, and an earlier line of standard error says so:
no metric is counted short.
"""

from __future__ import annotations

import time

import torch

# launch counter of the program (``ops.launch_counts``) → substrings of the
# kernel names that one counted launch runs at least once
PORT_KERNELS = {
    "haar_dwt3": ("haar_dwt3_kernel",),
    "haar_idwt3": ("haar_idwt3_kernel",),
    "affine_silu": ("affine_silu_kernel",),
    "affine_silu_bwd": ("affine_silu_bwd_reduce",),
    "conv3d_wgmma": ("conv3d_wgmma_kernel",),
    "conv3d_wgmma_n32": ("conv3d_wgmma_kernel",),
    "conv3d_splitk": ("conv3d_splitk_kernel",),
    "conv3d_wgmma_tf32": ("conv3d_tf32_kernel",),
    "conv3d_mma_sync": ("conv3d_bf16_kernel", "conv3d_f32_kernel"),
}
# the kernels of the fused GN→SiLU→conv (K4b), by name: its four kernels and
# the split-K kernel's second pass, which sums the partials
FUSED_CONV_KERNELS = ("conv3d_wgmma_kernel", "conv3d_splitk_kernel", "conv3d_splitk_reduce",
                      "conv3d_tf32_kernel", "conv3d_bf16_kernel", "conv3d_f32_kernel")

# device records of a synthesis request outside its reverse chain, by
# substrings of their names: the copies between host and card (the
# condition's and the mask's upload, the volume back), the condition's DWTs
# and the volume's IDWT (their records, or their CUDA-event fill), and the
# benchmark's own draws of each request's x_T and step noise
OUTSIDE_CHAIN = {
    "host_copies": ("Memcpy HtoD", "Memcpy DtoH"),
    "haar": ("haar_dwt3", "haar_idwt3"),
    "noise_draws": ("distribution_elementwise", "normal_and_transform"),
}


def outside_chain(kernels: dict) -> dict[str, list]:
    """``OUTSIDE_CHAIN``'s groups → ``[seconds, records]`` in ``kernels``."""
    out = {}
    for group, subs in OUTSIDE_CHAIN.items():
        hits = [v for name, v in kernels.items() if any(sub in name for sub in subs)]
        out[group] = [sum(v[0] for v in hits), sum(v[1] for v in hits)]
    return out


def missing_records(launched: dict[str, int], records: dict[str, int]) -> dict[str, list]:
    """Counter → ``[records, launches]`` where the trace holds fewer records of
    the counter's kernel than the counter says were launched. Counters that
    share a kernel name are summed first, under their names joined by ``+``."""
    want: dict[tuple, list] = {}
    for counter, names in PORT_KERNELS.items():
        entry = want.setdefault(names, [[], 0])
        entry[0].append(counter)
        entry[1] += launched.get(counter, 0)
    out = {}
    for names, (counters, n) in want.items():
        got = sum(c for k, c in records.items() if any(s in k for s in names))
        if got < n:
            out["+".join(counters)] = [got, n]
    return out


def events_seconds(fn, n: int = 20) -> float:
    """Device seconds of one ``fn()`` (a single kernel launch), by CUDA events
    around ``n`` launches enqueued behind a spin of the card, so that they
    run back to back (the program's ``devtime`` fallback)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(2_000_000)  # ~1 ms: longer than the launches take to enqueue
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n / 1e3


def fill_missing(summary: dict, timers: dict) -> dict:
    """Where the trace lost records of a kernel that ``timers`` can launch
    alone (counter → a callable launching it once at the block's shape), add
    the lost launches at their CUDA-event time to ``kernels`` (as ``<counter>
    (CUDA events)``) and to ``busy_s`` (one stream: they ran alone), and drop
    the entry from ``records_missing``. Returns what was filled."""
    filled = {}
    for key, (got, n) in list(summary["records_missing"].items()):
        if key not in timers:
            continue
        each = events_seconds(timers[key])
        summary["kernels"][f"{key} (CUDA events)"] = [(n - got) * each, n - got]
        summary["busy_s"] += (n - got) * each
        del summary["records_missing"][key]
        filled[key] = {"records": got, "launches": n, "event_s_each": each}
    return filled


class TracedBlock:
    """``with TracedBlock(launch_counts, launches_since, device) as tb: ...``
    profiles the block, synchronised at both ends; afterwards ``tb.summary``
    holds ``window_s`` (host clock), ``busy_s`` (the union of the device's
    operation intervals), ``kernels`` (name → [seconds, count]),
    ``launched`` (the program's counters over the block) and
    ``records_missing``. The numbers come from a trace of the device alone:
    recording every host operation as well slows an eager training step by a
    quarter and would put that into the idle share. With ``host=True`` the
    host's operations are traced too, and ``gaps`` names the block's longest
    idle intervals by the benchmark span and the host operation in progress
    at their start.

    The tracer is warmed before the block by a few spins of the card, whose
    records, and anything before their end, are left out: CUPTI has been seen
    to drop the first kernel records of a trace."""

    def __init__(self, launch_counts, launches_since, device, host: bool = False):
        self.launch_counts, self.launches_since = launch_counts, launches_since
        self.cuda, self.host = device.type == "cuda", host or device.type != "cuda"
        self.summary: dict = {}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.before = self.launch_counts()
        self.prof = profile(activities=([ProfilerActivity.CPU] if self.host else [])
                            + ([ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.__enter__()
        if self.cuda:
            for _ in range(WARM_SPINS):
                torch.cuda._sleep(WARM_CYCLES)
            torch.cuda.synchronize()
        self.span = torch.profiler.record_function("bench.block")
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self.prof.events(), window_s,
                                     self.launches_since(self.before))
        return False


WARM_SPINS, WARM_CYCLES = 8, 20_000  # ~10 µs each at the card's clock


def summarize(events, window_s: float, launched: dict) -> dict:
    from torch.autograd import DeviceType

    warm_end = max((e.time_range.end for e in events
                    if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name),
                   default=float("-inf"))
    dev, cpu, kernels = [], [], {}
    block = None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        on_device = e.device_type == DeviceType.CUDA
        if on_device and (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")
                          or start <= warm_end):
            continue  # a span's copy on the device's timeline, or the tracer's warm-up
        if e.name == "bench.block":
            block = (start, end)
        elif on_device:
            dev.append((start, end))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (end - start) / 1e6
            k[1] += 1
        elif end > start:
            cpu.append((start, end, e.name))
    dev.sort()
    merged: list[list[float]] = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    records = {k: v[1] for k, v in kernels.items()}
    out = {
        "window_s": window_s,
        "busy_s": sum(t - s for s, t in merged) / 1e6,
        "kernels": kernels,
        "launched": launched,
        "records_missing": missing_records(launched, records),
    }
    if block and cpu:
        edges = [block[0]] + [x for st in merged for x in st] + [block[1]]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
        named: dict[str, float] = {}
        for length, at in gaps:
            name = _host_at(cpu, at)
            named[name] = named.get(name, 0.0) + length / 1e6
        out["gaps"] = sorted(named.items(), key=lambda kv: -kv[1])
    return out


def _host_at(cpu: list, at: float) -> str:
    """``span/op``: the innermost ``bench.*`` span and the innermost other host
    event that were open at time ``at``."""
    span = op = None
    for s, t, name in cpu:
        if s <= at < t:
            if name.startswith("bench."):
                if span is None or s >= span[0]:
                    span = (s, name)
            elif op is None or s >= op[0]:
                op = (s, name)
    parts = [p[1] for p in (span, op) if p is not None]
    return "/".join(parts) if parts else "host idle"


def top_device_ops(kernels: dict, n: int = 10) -> list:
    return [[name, v[0]] for name, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]]


def traced(work, n: int, launch_counts, launches_since, device, timers=None) -> dict:
    """``work(j)`` for j < n in a block traced on the device alone (the
    summary's numbers), then for n ≤ j < 2n in a block with the host traced
    too (the summary's ``gaps``). Lost records of a kernel in ``timers`` are
    filled by CUDA events (:func:`fill_missing`, listed under ``filled``)."""
    with TracedBlock(launch_counts, launches_since, device) as numbers:
        for j in range(n):
            work(j)
    with TracedBlock(launch_counts, launches_since, device, host=True) as named:
        for j in range(n, 2 * n):
            work(j)
    out = {**numbers.summary, "gaps": named.summary.get("gaps", [])}
    out["filled"] = fill_missing(out, timers or {}) if device.type == "cuda" else {}
    return out
