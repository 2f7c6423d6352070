"""Multi-process dry run of the data-, spatially- and tensor-parallel path
on the CPU (the counterpart of ``__graft_entry__.py::dryrun_multichip``).

    python -m fast_cwdm_tpu_torch.parallel.dryrun [N [SP [TP]]]   # default 2 ranks

:func:`dryrun_multichip` starts ``n`` processes on this host, each a rank
of one ``gloo`` process group on the CPU (:func:`start_ranks`), on the
mesh the JAX dry run picks: sp 2 where n is even and above 1, tp 2 where
4 divides n, data the rest (8 ranks: ``{"data": 2, "sp": 2, "tp": 2}``).
Each rank shards the JAX dry run's tiny UNet (16³ images, 32 base
channels, two ResBlocks a level) over tp (``shard_params``), runs one
train step on its rows and Y slab of a global batch of ``data``, then a
sharded synthesis of that batch. The ranks must agree on the loss, the
gathered parameters (bit for bit) and the synthesis.

:func:`start_ranks` and :func:`wait_ranks` are the launcher the tests and
``scripts/scaling_bench.py`` use as well: torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
on a free localhost port, and every process killed if any outlives the
timeout.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULT = "RESULT "


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(n: int, argv: list[str], *, env: dict | None = None,
                threads: int = 1) -> list[subprocess.Popen]:
    """``python argv…`` as ``n`` ranks of one process group on localhost,
    with ``threads`` CPU threads each; stdout and stderr piped."""
    port = free_port()
    procs = []
    for rank in range(n):
        e = dict(os.environ if env is None else env)
        e.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                 LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS=str(threads),
                 PYTHONPATH=os.pathsep.join(p for p in (REPO, e.get("PYTHONPATH")) if p))
        procs.append(subprocess.Popen([sys.executable, *argv], env=e, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def wait_ranks(procs: list[subprocess.Popen], timeout: float) -> list[tuple[int, str, str]]:
    """``(returncode, stdout, stderr)`` of every rank. Each rank gets at most
    ``timeout`` seconds; on a timeout every rank still running is killed
    and ``TimeoutError`` raised."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    except subprocess.TimeoutExpired as exc:
        raise TimeoutError(f"a rank outlived {timeout} s") from exc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def results(runs: list[tuple[int, str, str]]) -> list[dict]:
    """The ``RESULT {json}`` line of every rank; raises with the stderr of
    a rank that failed."""
    recs = []
    for rank, (rc, o, e) in enumerate(runs):
        if rc != 0:
            raise RuntimeError(f"rank {rank} exited {rc}:\n{e[-3000:]}")
        lines = [ln[len(RESULT):] for ln in o.splitlines() if ln.startswith(RESULT)]
        if len(lines) != 1:
            raise RuntimeError(f"rank {rank} printed {len(lines)} results:\n{o[-2000:]}")
        recs.append(json.loads(lines[0]))
    return recs


def params_digest(tensors) -> str:
    """sha256 of the parameters' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def tiny_unet(image_size: int = 16):
    """The JAX dry run's UNet (``__graft_entry__.py``) with seeded weights."""
    import torch

    from fast_cwdm_tpu_torch.models.unet import UNetModel
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    model = UNetModel(image_size=image_size, in_channels=32, model_channels=32, out_channels=8,
                      num_res_blocks=2, attention_resolutions=(), channel_mult=(1, 2), dims=3,
                      num_groups=8, resblock_updown=True, bottleneck_attention=False,
                      resample_2d=False)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _worker() -> None:
    """One rank: a data-parallel train step and a sharded synthesis."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fast_cwdm_tpu_torch.cli.common import make_synthesis_fn, prepare_condition
    from fast_cwdm_tpu_torch.diffusion.gaussian import MODALITIES, GaussianDiffusion
    from fast_cwdm_tpu_torch.parallel.mesh import (
        gather_params,
        make_mesh,
        setup_distributed,
        shard_batch,
        shard_params,
    )
    from fast_cwdm_tpu_torch.training.state import TrainState
    from fast_cwdm_tpu_torch.training.train import StepRNG, make_optimizer, make_train_step

    setup_distributed("cpu")
    mesh = make_mesh(sp=int(sys.argv[2]), tp=int(sys.argv[3]))
    model = shard_params(mesh, tiny_unet())
    diffusion = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    opt = make_optimizer(1e-4, lr_anneal_steps=100)
    b, s = mesh.size, 16
    rng = np.random.default_rng(0)
    batch = {m: rng.random((b, s, s, s, 1), dtype=np.float32) for m in MODALITIES}
    step = make_train_step(model, diffusion, opt, contr="t1c", mode="i2i", mesh=mesh)
    state = TrainState.create(model, opt, ema_rates=(0.9999,))
    state, metrics = step(state, shard_batch(mesh, batch, device="cpu"),
                          StepRNG.seeded(1, "cpu"))
    loss = float(metrics["loss"])
    synth = make_synthesis_fn(model, diffusion, crop_z=s, mesh=mesh, device="cpu")
    out = synth(prepare_condition(batch, "t1c", device="cpu", mesh=mesh), batch["t1n"],
                torch.Generator().manual_seed(2))
    print(RESULT + json.dumps({
        "rank": mesh.process_rank, "mesh": mesh.shape, "loss": loss, "step": state.step,
        "params": params_digest(gather_params(mesh, model, state.params).values()),
        "synthesis_shape": list(out.shape), "synthesis_finite": bool(np.isfinite(out).all()),
        "synthesis": hashlib.sha256(out.tobytes()).hexdigest()}), flush=True)
    dist.destroy_process_group()


def mesh_axes(n: int, sp: int | None = None, tp: int | None = None) -> tuple[int, int]:
    """``(sp, tp)`` of the dry run over ``n`` ranks: with neither given, the
    JAX dry run's choice (``__graft_entry__.py``: sp 2 where n is even and
    above 1, tp 2 where 4 divides n); an axis not given is otherwise 1."""
    if sp is None and tp is None:
        return (2 if n % 2 == 0 and n > 1 else 1), (2 if n % 4 == 0 else 1)
    return sp or 1, tp or 1


def dryrun_multichip(n: int = 2, timeout: float = 120.0, sp: int | None = None,
                     tp: int | None = None) -> dict:
    """Run the dry run over ``n`` gloo ranks on the CPU on the mesh
    ``make_mesh(data=n // (sp·tp), sp=sp, tp=tp)`` (``sp``/``tp``:
    :func:`mesh_axes`); returns rank 0's record after checking that every
    rank agrees (loss, gathered parameters and the gathered synthesis, bit
    for bit) and that the loss is finite."""
    sp, tp = mesh_axes(n, sp, tp)
    if n % (sp * tp):
        raise ValueError(f"{n} ranks do not split into sp groups of {sp} and tp groups of {tp}")
    data = n // (sp * tp)
    argv = ["-m", "fast_cwdm_tpu_torch.parallel.dryrun", "--worker", str(sp), str(tp)]
    recs = results(wait_ranks(start_ranks(n, argv), timeout))
    first = recs[0]
    for r in recs:
        for k in ("mesh", "loss", "step", "params", "synthesis", "synthesis_shape"):
            if r[k] != first[k]:
                raise RuntimeError(f"ranks disagree on {k}: {[x[k] for x in recs]}")
    if not math.isfinite(first["loss"]):
        raise RuntimeError(f"non-finite loss {first['loss']}")
    want = {"data": data, "sp": sp, **({"tp": tp} if tp > 1 else {})}
    if first["mesh"] != want or first["step"] != 1 \
            or not first["synthesis_finite"] or first["synthesis_shape"] != [data, 16, 16, 16]:
        raise RuntimeError(f"dry run record off: {first}")
    print(f"dryrun_multichip OK: mesh={first['mesh']} loss={first['loss']:.5f}")
    return first


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker()
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                         sp=int(sys.argv[2]) if len(sys.argv) > 2 else None,
                         tp=int(sys.argv[3]) if len(sys.argv) > 3 else None)
