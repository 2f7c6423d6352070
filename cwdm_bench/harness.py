"""The benchmark of ``fast_cwdm_tpu_torch``: one cell a run.

``python3 cwdm_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout. Everything a cell needs is found by name:

- the cell in ``BENCHMARK.json`` (its configuration, traffic mix and metrics);
- ``cwdm_bench/configs/<config>.json``: the configuration as it is run;
- ``cwdm_bench/traffic/<mix>.json``: the mix's parameters; its ``kind`` names
  the general driver that reads it (``synthesis`` or ``training``, a module
  of this package);
- ``cwdm_bench/limits/<cell>.json``: the limit of each number compared;
- ``cwdm_bench/metrics/<metric>.py``: one reader a metric, ``read(rec)``,
  which returns the metric's value from the run's record or None where the
  record holds nothing to read it from.

A run: set-up (build, weights, cases, the program's warm-up), the measured
window, with ``--trace 1`` a traced block after it, then the check of what
the window produced against the plain reference in ``reference/``. The last
line of standard output is the result; the last lines of standard error are
the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_cwdm_tpu")


def log(**kv) -> None:
    """One JSON line on standard error."""
    print(json.dumps(kv, default=float), file=sys.stderr, flush=True)


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed of its own for each purpose and index under ``seed``."""
    words = [int(seed) % 2**64] + [k if isinstance(k, int) else zlib.crc32(k.encode())
                                   for k in keys]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint32).view(np.uint64)[0]
               >> np.uint64(1))


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metric entries."""
    bench = _read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return {
        "cell": cell,
        "config": _read_json(ROOT / conf["file"]),
        "traffic": _read_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "limits": _read_json(BENCH / "limits" / f"{workload}.json"),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


@dataclass
class Run:
    """What a driver gets: the run's options, the cell's configuration,
    traffic and limits, and where it records its set-up parts."""

    seed: int
    seconds: float
    trace: bool
    device: object
    config: dict
    traffic: dict
    limits: dict
    t_start: float
    setup: dict = field(default_factory=dict)
    _mark: float = 0.0

    def part(self, name: str) -> None:
        """Close the set-up part ``name`` at the host clock's now."""
        now = time.perf_counter()
        self.setup[name] = now - (self._mark or self.t_start)
        self._mark = now


def draw_weights(shapes: dict, seed: int, device) -> dict:
    """Every parameter from one normal draw on ``device``: weights of two or
    more dimensions at the fan-in scale N(0, 1/fan_in), GroupNorm scales
    1 + 0.05·N(0, 1), biases 0.02·N(0, 1). Not the model's own initialisation,
    which zeroes each ResBlock's last conv and the output conv."""
    import torch

    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            v = v * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith(".weight"):
            v = 1.0 + 0.05 * v
        else:
            v = 0.02 * v
        out[name] = v
    return out


def build_program(model_cfg: dict, seed: int, device):
    """``(model, diffusion)`` of the program for ``model_cfg``, its
    parameters the seeded draw (loaded ``strict``: the reference's layout)."""
    import torch

    from cwdm_bench.reference import cwdm
    from fast_cwdm_tpu_torch.cli import common

    with torch.device("meta"):
        model, diffusion = common.build_model_and_diffusion(model_cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(draw_weights(cwdm.param_shapes(model_cfg), seed, device), strict=True)
    return model, diffusion


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


class HostLoad:
    """``with HostLoad() as h: ...``; then ``h.summary``: what the host did
    over the block, for a line on standard error: the process's CPU seconds
    (every thread), its voluntary and involuntary context switches, and the
    seconds and count of Python's garbage collections by generation."""

    def __enter__(self):
        import resource

        self._gc = {"s": [0.0, 0.0, 0.0], "n": [0, 0, 0], "t": 0.0}
        gc.callbacks.append(self._collect)
        self._r0 = resource.getrusage(resource.RUSAGE_SELF)
        self._t0 = time.perf_counter()
        return self

    def _collect(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc["t"] = time.perf_counter()
        else:
            g = info["generation"]
            self._gc["s"][g] += time.perf_counter() - self._gc["t"]
            self._gc["n"][g] += 1

    def __exit__(self, *exc):
        import resource

        r1, wall = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter() - self._t0
        gc.callbacks.remove(self._collect)
        cpu = (r1.ru_utime - self._r0.ru_utime) + (r1.ru_stime - self._r0.ru_stime)
        self.summary = {"wall_s": wall, "cpu_s": cpu, "cpu_share": cpu / wall,
                        "ctx_voluntary": r1.ru_nvcsw - self._r0.ru_nvcsw,
                        "ctx_involuntary": r1.ru_nivcsw - self._r0.ru_nivcsw,
                        "gc_s": self._gc["s"], "gc_collections": self._gc["n"]}
        return False


def slice_rates(ends: list[float], t0: float, width: float = 10.0) -> list[float]:
    """Seconds an item in each ``width``-second slice of the window, from
    the host times at which the items ended: whether a run's pace drifts
    inside its window or only from one run to the next."""
    out, start, n = [], t0, 0
    for j, end in enumerate(ends):
        n += 1
        if end - start >= width or j == len(ends) - 1:
            out.append((end - start) / n)
            start, n = end, 0
    return out


def reset_peak(dev) -> None:
    """Start the memory peak that ``device_record`` reads at the window's
    start, so that set-up's own buffers (the phantoms' making, the weights'
    draw) do not count."""
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def device_record(dev, count: int) -> dict:
    """The result's ``device``: what ran, and the peak of allocated memory on
    the fullest card since ``reset_peak`` (the window and, with ``--trace 1``,
    the traced block; read before the reference runs)."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def wavelet_timers(run: Run) -> dict:
    """The program's K1 and K2, each launched once at the cell's shapes (a
    volume, and its latent of 8 subbands), for ``devtrace.fill_missing``."""
    import torch

    from fast_cwdm_tpu_torch.ops import wavelet_cuda

    geo, b = run.config["geometry"], int(run.traffic["batch"])
    shape = (b, geo["raw"][0] - 2 * geo["crop_xy"], geo["raw"][1] - 2 * geo["crop_xy"],
             geo["pad_z"])
    vol = torch.rand(shape, device=run.device)
    lat = torch.rand((*[s // 2 for s in shape], 8), device=run.device)
    return {"haar_dwt3": lambda: wavelet_cuda.haar_dwt3(vol),
            "haar_idwt3": lambda: wavelet_cuda.haar_idwt3(lat)}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cwdm_bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_info() -> dict:
    import torch

    info = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        info["nvidia_smi"] = f"unavailable: {e}"
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, config: dict | None = None,
             traffic: dict | None = None) -> dict:
    """Run one cell and return its result (the dict of the result line).
    ``config`` / ``traffic`` replace the cell's files (tests run a tiny
    configuration on the CPU this way)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(workload)
    run = Run(seed, seconds, trace, torch.device(device), config or spec["config"],
              traffic or spec["traffic"], spec["limits"], t_start)
    prec = run.config["precision"]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = prec["tf32"]
    driver = importlib.import_module(f"cwdm_bench.{run.traffic['kind']}")
    rec = driver.run(run)

    readings = rec.pop("readings")
    checks = {k: [v, run.limits[k]] for k, v in readings.items()}
    # a request or step of the window that failed (a non-finite loss) makes
    # the run incorrect, whatever the checked ones read
    checks["failed"] = [rec["failed"], 0]
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in entries:
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": rec["device"]}
    if trace and rec.get("trace"):
        from cwdm_bench import devtrace

        tr = rec["trace"]
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": devtrace.top_device_ops(tr["kernels"]),
                            "idle_gaps": [list(g) for g in tr["gaps"]]}
    out["limits"] = checks
    return out


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = load_cell(args.workload)["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cwdm_bench: {args.workload} needs {chips} CUDA device(s), found {n}; "
              "nothing runs on another device", file=sys.stderr)
        return 2
    log(device=card_info())
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"cwdm_bench: modules that may not load in a run were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in result["limits"].items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
