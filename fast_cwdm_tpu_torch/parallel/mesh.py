"""The ``data`` axis over ``torch.distributed`` (port of the data-parallel
half of ``fast_cwdm_tpu/parallel/mesh.py``).

The JAX package drives N chips from one process: a ``jax.sharding.Mesh``
whose ``data`` axis shards the batch, with XLA inserting the gradient
``psum``. Its counterpart here is one process per GPU, started by
``torchrun``:

* :func:`setup_distributed` joins the process group from torchrun's
  variables (``nccl`` on CUDA, ``gloo`` on the CPU) and pins the rank's GPU;
* :func:`make_mesh` describes the data axis (:class:`DataMesh`): its size is
  the world size, and every rank holds the whole model;
* :func:`local_batch_rows` / :func:`shard_batch` give each rank the
  contiguous rows ``[rank·b, (rank+1)·b)`` of the global batch;
* :func:`all_reduce_mean_`, :func:`all_gather_rows` and :func:`any_rank`
  are the collectives the train step, the resampler, the loop and
  synthesis issue by hand (there is no compiler to insert them).

The ``sp`` and ``tp`` axes (spatial sharding with halo exchanges,
column-parallel convs) are not ported; asking for either raises
``NotImplementedError``. ``batch_spec``, ``batch_sharding``,
``replicated``, ``param_spec`` and ``shard_params`` describe XLA
shardings and have no counterpart.

``FAST_CWDM_DIST_BACKEND`` (``gloo`` or ``nccl``) overrides the backend:
NCCL refuses two ranks on one GPU, gloo takes them (its collectives are
staged through host memory here).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from fast_cwdm_tpu_torch import resolve_device

DATA_AXIS = "data"
SPATIAL_AXIS = "sp"
TENSOR_AXIS = "tp"
RENDEZVOUS_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
NOT_PORTED = ("ROADMAP §1 M8: the sp and tp axes are not ported (they need a "
              "halo-exchanging conv and DWT, and column-parallel convs)")


def setup_distributed(device: str | torch.device | None = None) -> torch.device:
    """Join the process group that ``torchrun`` describes and return the
    device this rank runs on (``device``, default ``cuda``, pinned to
    ``LOCAL_RANK``'s GPU). A single process with none of the variables is a
    no-op that returns ``device`` resolved.

    Refusals, as the JAX package's: a partial set of ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
    raises and names the missing ones; managed-cluster markers (SLURM with
    several tasks, Open MPI) without them raise, since every process would
    otherwise train as rank 0 of 1 and race on the checkpoint files, unless
    ``FAST_CWDM_ALLOW_SINGLE_PROCESS=1``.
    """
    dev = resolve_device(device)
    env = {k: os.environ.get(k) for k in RENDEZVOUS_VARS}
    if not any(env.values()):
        managed = (int(os.environ.get("SLURM_NTASKS", "1") or 1) > 1
                   or int(os.environ.get("OMPI_COMM_WORLD_SIZE", "1") or 1) > 1
                   or bool(os.environ.get("OMPI_MCA_orte_hnp_uri")))
        if not managed:
            return dev
        if os.environ.get("FAST_CWDM_ALLOW_SINGLE_PROCESS"):
            print("[setup_distributed] WARNING: managed-cluster markers present but no "
                  "torchrun rendezvous; FAST_CWDM_ALLOW_SINGLE_PROCESS is set — continuing "
                  "single-process.")
            return dev
        raise RuntimeError(
            "managed-cluster markers present (SLURM/Open MPI) but none of "
            f"{', '.join(RENDEZVOUS_VARS)}. Refusing to degrade to single-process — every "
            "process would train an independent replica and race on shared checkpoint "
            "files. Launch with torchrun (or set those variables), or set "
            "FAST_CWDM_ALLOW_SINGLE_PROCESS=1 to accept single-process.")
    missing = [k for k, v in env.items() if not v]
    if missing:
        raise RuntimeError(
            f"a torch.distributed launch needs ALL of {', '.join(RENDEZVOUS_VARS)}; "
            f"missing: {', '.join(missing)}")
    rank, world, local = (int(env[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    backend = os.environ.get("FAST_CWDM_DIST_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world > n and backend == "nccl":
            raise RuntimeError(
                f"{local_world} ranks on this host and {n} GPU(s): NCCL takes one rank per "
                "GPU; start fewer ranks, or set FAST_CWDM_DIST_BACKEND=gloo to share GPUs")
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                                f"{env['MASTER_PORT']}", world_size=world, rank=rank)
    return dev


@dataclass(frozen=True)
class DataMesh:
    """The data axis: ``shape`` as the JAX mesh's (``{"data": world size,
    "sp": 1}``), the process ``group`` (None in a single process, where
    every collective is the identity) and this rank's index on the axis."""

    shape: dict
    group: object
    rank: int

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS]


def make_mesh(data: int = -1, sp: int = 1, tp: int = 1) -> DataMesh:
    """The ``(data, sp)`` mesh of the process group. ``data=-1`` is the
    world size; any other value must equal it (one process per GPU cannot
    pin a sub-mesh as the JAX package does). ``sp`` or ``tp`` > 1 raises
    ``NotImplementedError``."""
    if sp > 1 or tp > 1:
        raise NotImplementedError(f"make_mesh(sp={sp}, tp={tp}): {NOT_PORTED}")
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if data == -1:
        data = world
    if data != world:
        raise ValueError(
            f"mesh data={data} but the process group has {world} rank(s): the data axis "
            f"is the world size (launch torchrun --nproc_per_node={data}, or pass data=-1)")
    return DataMesh({DATA_AXIS: world, SPATIAL_AXIS: 1},
                    dist.group.WORLD if up else None, dist.get_rank() if up else 0)


def make_hybrid_mesh(sp: int = 1) -> DataMesh:
    """The same as :func:`make_mesh`: under torchrun the data axis spans the
    hosts as it is."""
    return make_mesh(sp=sp)


def local_batch_size(global_batch: int, mesh: DataMesh) -> int:
    """Rows of ``global_batch`` each rank holds."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {mesh.size}")
    return global_batch // mesh.size


def local_batch_rows(mesh: DataMesh, global_batch: int) -> tuple[int, int]:
    """This rank's contiguous ``[start, stop)`` rows of a ``global_batch``-row
    batch. Every rank builds the same seeded case order and decodes only
    these rows of each batch."""
    b = local_batch_size(global_batch, mesh)
    return mesh.rank * b, (mesh.rank + 1) * b


def shard_batch(mesh: DataMesh, tree, *, global_batch: int | None = None,
                device: str | torch.device | None = None):
    """This rank's rows of a batch (a dict of arrays or tensors, or one), on
    ``device`` (default ``cuda``). ``tree`` holds the GLOBAL batch, or,
    with ``global_batch``, only this rank's rows already (the multi-host
    input contract: each rank decodes its own rows)."""
    from fast_cwdm_tpu_torch.data.loader import to_device

    leaves = tree.values() if isinstance(tree, dict) else [tree]
    n = {len(v) for v in leaves}
    if len(n) != 1:
        raise ValueError(f"batch leaves disagree on their row count: {sorted(n)}")
    (n,) = n
    if global_batch is None:
        lo, hi = local_batch_rows(mesh, n)
        tree = ({k: v[lo:hi] for k, v in tree.items()} if isinstance(tree, dict)
                else tree[lo:hi])
    elif n != local_batch_size(global_batch, mesh):
        raise ValueError(f"a rank feeds {local_batch_size(global_batch, mesh)} of "
                         f"{global_batch} rows; got {n}")
    return to_device(tree, resolve_device(device))


# -- collectives -------------------------------------------------------------


def _staged(mesh: DataMesh) -> bool:
    """gloo runs on host tensors: collectives copy through host memory."""
    return dist.get_backend(mesh.group) == "gloo"


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class CommLog:
    """Bytes and milliseconds of every gradient all-reduce, read by the
    training loop. On NCCL the time is taken with CUDA events around the
    collective, without a synchronisation (it is read at :meth:`drain`);
    through gloo with the host clock, between synchronisations."""

    def __init__(self):
        self._records: list = []

    def add(self, n_bytes: int, ms) -> None:
        self._records.append((n_bytes, ms))

    def drain(self) -> list[tuple[int, float]]:
        """``(bytes, ms)`` of each call since the last drain."""
        out = []
        for n_bytes, ms in self._records:
            if isinstance(ms, tuple):
                ms[1].synchronize()
                ms = ms[0].elapsed_time(ms[1])
            out.append((n_bytes, float(ms)))
        self._records = []
        return out


def all_reduce_mean_(mesh: DataMesh, tensors: list[torch.Tensor],
                     log: CommLog | None = None) -> None:
    """Replace each of ``tensors`` (float32, on one device) by its mean over
    the data axis, in place, with ONE all-reduce of a flat buffer. Every
    rank ends with the same bits."""
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    n_bytes = flat.numel() * flat.element_size()
    if _staged(mesh):
        _sync(flat)
        t0 = time.perf_counter()
        host = flat.cpu()
        dist.all_reduce(host, group=mesh.group)
        flat.copy_(host)
        _sync(flat)
        ms = (time.perf_counter() - t0) * 1e3
    else:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(flat, group=mesh.group)
        end.record()
        ms = (start, end)
    flat.div_(mesh.size)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()
    if log is not None:
        log.add(n_bytes, ms)


def all_gather_rows(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank."""
    if mesh.group is None:
        return x
    src = x.detach().contiguous()
    if _staged(mesh):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(x.device)


def any_rank(mesh: DataMesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any."""
    if mesh.group is None:
        return bool(flag)
    dev = "cpu" if _staged(mesh) else torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def gather_metrics(mesh: DataMesh, metrics: dict, per_sample: tuple[str, ...]) -> dict:
    """``metrics`` on the host as numpy, the ``per_sample`` leaves (rows of
    this rank's batch) gathered across ranks in rank order. Collective:
    every rank calls it at the same steps."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            v = (all_gather_rows(mesh, v) if k in per_sample else v).detach().cpu().numpy()
        out[k] = v
    return out
