"""Weak-scaling readiness of the data axis, as gloo processes on the CPU
(the counterpart of ``scripts/scaling_bench.py``).

    python -m fast_cwdm_tpu_torch.scripts.scaling_bench [--widths 1,2,4,8]

For each width n, n ranks (``parallel/dryrun.py::start_ranks``) each hold
one volume of a global batch of n (weak scaling) and run

* ``make_synthesis_fn(mesh=)`` (ddpm, the 10-step sampled schedule), which
  must equal the unsharded synthesis of the same batch within 1e-5;
* one data-parallel train step, whose loss must equal the unsharded step's
  on the same batch, t and noise within 2e-5;
* the same two under ``torch.utils.flop_counter.FlopCounterMode`` (the
  counterpart of XLA's ``cost_analysis``): a rank's FLOPs must stay the
  same at every width, since each rank does the same work on its own
  volume and the ranks exchange only the gradient all-reduce and the
  gathered images.

The mesh is ``make_mesh()``: the data axis alone, ``{"data": n, "sp": 1}``
(the sp and tp axes, which split one volume's work over ranks, are held
to one process by ``tests/test_torch_spatial.py``,
``tests/test_torch_tensor.py`` and ``parallel/dryrun.py``, whose 8-rank
run is the JAX dry run's ``{"data": 2, "sp": 2, "tp": 2}``). The model is
the JAX bench's tiny UNet (16 base channels, 16³ images).
Prints one JSON line per width, then a summary line; exits 1 when any
check fails. The seconds are host-CPU wall times of gloo processes, not a
GPU measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

WIDTHS = (1, 2, 4, 8)
SIZE = 16  # image side; the latent is 8³
TINY = dict(image_size=8, in_channels=32, model_channels=16, out_channels=8, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3, num_groups=8,
            resblock_updown=True, bottleneck_attention=False, resample_2d=False)


def _setup(n: int):
    """Model (seeded), diffusion, the global batch of n, its condition."""
    import numpy as np
    import torch

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.diffusion.gaussian import MODALITIES, GaussianDiffusion
    from fast_cwdm_tpu_torch.models.unet import UNetModel
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    model = UNetModel(**TINY)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    diffusion = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    rng = np.random.default_rng(42)
    batch = {m: rng.random((n, SIZE, SIZE, SIZE, 1), dtype=np.float32) for m in MODALITIES}
    return model, diffusion, batch, common.prepare_condition(batch, "t1c", device="cpu")


def _run(n: int, mesh=None) -> dict:
    """Synthesis and one train step at width n (``mesh``: this rank's
    share); their results, FLOPs and host seconds."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.parallel.mesh import shard_batch
    from fast_cwdm_tpu_torch.training.state import TrainState
    from fast_cwdm_tpu_torch.training.train import StepRNG, make_optimizer, make_train_step

    model, diffusion, batch, cond = _setup(n)
    synth = common.make_synthesis_fn(model, diffusion, crop_z=SIZE, mesh=mesh, device="cpu")
    with FlopCounterMode(display=False) as fc:
        t0 = time.perf_counter()
        out = synth(cond, batch["t1n"], torch.Generator().manual_seed(3))
        synth_s = time.perf_counter() - t0
    synth_flops = fc.get_total_flops()
    opt = make_optimizer(1e-4)
    step = make_train_step(model, diffusion, opt, contr="t1c", mode="i2i", mesh=mesh)
    state = TrainState.create(model, opt)
    local = shard_batch(mesh, batch, device="cpu") if mesh is not None else {
        k: torch.from_numpy(v) for k, v in batch.items()}
    with FlopCounterMode(display=False) as fc:
        t0 = time.perf_counter()
        _, m = step(state, local, StepRNG.seeded(5, "cpu"))
        loss = float(m["loss"])
        step_s = time.perf_counter() - t0
    return {"synthesis": out, "loss": loss, "synth_flops": synth_flops,
            "step_flops": fc.get_total_flops(), "synth_cpu_s": synth_s, "step_cpu_s": step_s,
            "allreduce_bytes": sum(b for b, _ in step.comm.drain())}


def _worker(n: int, out_dir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from fast_cwdm_tpu_torch.parallel.mesh import make_mesh, setup_distributed

    torch.set_num_threads(1)
    setup_distributed("cpu")
    mesh = make_mesh()
    res = _run(n, mesh)
    if mesh.rank == 0:
        np.save(os.path.join(out_dir, f"synth_{n}.npy"), res.pop("synthesis"))
    else:
        res.pop("synthesis")
    print("RESULT " + json.dumps({"rank": mesh.rank, **res}), flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    import tempfile

    import numpy as np
    import torch

    from fast_cwdm_tpu_torch.parallel import dryrun

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per width")
    args = ap.parse_args(argv)
    widths = [int(w) for w in args.widths.split(",")]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in widths:
            t0 = time.perf_counter()
            procs = dryrun.start_ranks(
                n, ["-m", "fast_cwdm_tpu_torch.scripts.scaling_bench", "--worker", str(n), tmp])
            recs = dryrun.results(dryrun.wait_ranks(procs, args.timeout))
            ranks_s = time.perf_counter() - t0
            sharded = np.load(os.path.join(tmp, f"synth_{n}.npy"))
            threads = torch.get_num_threads()
            torch.set_num_threads(1)  # as each rank: the CPU kernels' reduction order
            try:
                ref = _run(n)
            finally:
                torch.set_num_threads(threads)
            row = {
                "data": n, "global_batch": n,
                "synth_max_abs_diff": float(np.abs(sharded - ref["synthesis"]).max()),
                "train_loss_unsharded": ref["loss"],
                "train_loss_sharded": [r["loss"] for r in recs],
                # a rank's FLOPs: the same at every width (weak scaling)
                "per_rank_synth_gflops": [r["synth_flops"] / 1e9 for r in recs],
                "per_rank_step_gflops": [r["step_flops"] / 1e9 for r in recs],
                "unsharded_step_gflops": ref["step_flops"] / 1e9,
                "allreduce_bytes_per_step": recs[0]["allreduce_bytes"],
                "rank_synth_cpu_s": [r["synth_cpu_s"] for r in recs],
                "rank_step_cpu_s": [r["step_cpu_s"] for r in recs],
                "launch_to_exit_cpu_s": ranks_s,
            }
            row["ok"] = bool(row["synth_max_abs_diff"] < 1e-5 and all(
                abs(v - ref["loss"]) < 2e-5 for v in row["train_loss_sharded"]))
            rows.append(row)
            print(json.dumps(row), flush=True)
    step_flops = [r["per_rank_step_gflops"][0] for r in rows]
    synth_flops = [r["per_rank_synth_gflops"][0] for r in rows]
    flat = len({pair for r in rows
                for pair in zip(r["per_rank_step_gflops"], r["per_rank_synth_gflops"])}) == 1
    summary = {
        "harness": "weak_scaling_gloo_cpu", "widths": widths,
        "all_ok": all(r["ok"] for r in rows) and flat,
        "per_rank_flops_constant": flat,
        "per_rank_step_flops_ratio_widest_over_narrowest": step_flops[-1] / step_flops[0],
        "per_rank_synth_flops_ratio_widest_over_narrowest": synth_flops[-1] / synth_flops[0],
    }
    print(json.dumps(summary), flush=True)
    return 0 if summary["all_ok"] else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
