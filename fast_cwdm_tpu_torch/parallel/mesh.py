"""The ``data``, ``sp`` and ``tp`` axes over ``torch.distributed`` (port
of ``fast_cwdm_tpu/parallel/mesh.py``).

The JAX package drives N chips from one process: a ``jax.sharding.Mesh``
whose ``data`` axis shards the batch, whose ``sp`` axis shards the Y axis
of every volume (axis 2 of (B, X, Y, Z, C)) and whose ``tp`` axis shards
the output channels of the parameters (``param_spec``), with XLA inserting
the gradient ``psum`` and GSPMD the convolutions' halo exchanges and the
channel gathers. Here it is one process per GPU, started by ``torchrun``,
and every collective is written out:

* :func:`setup_distributed` joins the process group from torchrun's
  variables (``nccl`` on CUDA, ``gloo`` on the CPU) and pins the rank's GPU;
* :func:`make_mesh` describes the ``(data, sp, tp)`` mesh (:class:`DataMesh`)
  in the JAX mesh's order, ``tp`` innermost: process ``r`` is tp index
  ``r % tp``, sp index ``(r // tp) % sp`` and data index ``r // (sp·tp)``
  (a tp group is consecutive ranks, an sp group the ranks of one data and
  tp index);
* :func:`local_batch_rows` / :func:`shard_batch` give each data index the
  contiguous rows ``[d·b, (d+1)·b)`` of the global batch, and each sp index
  its Y slab; the ranks of a tp group hold the same rows and slab;
* :func:`all_reduce_mean_`, :func:`all_gather_rows` and :func:`any_rank`
  are the collectives the train step, the resampler, the loop and
  synthesis issue by hand;
* the ``sp`` collectives (:func:`halo_exchange`, :func:`all_reduce_sum_sp`,
  :func:`global_sum_sp`, :func:`all_gather_sp`, :func:`local_slab`), each
  an autograd Function, over the :class:`SpAxis` that :func:`sp_active`
  makes current; the UNet's convolutions, GroupNorms, wavelets and the
  losses read it with :func:`current_sp`;
* the ``tp`` axis: :func:`param_spec` is the JAX package's rule (a
  parameter of two or more axes whose output-channel axis ``tp`` divides
  is sharded along it, the rest replicated), :func:`shard_params` keeps
  each rank's slice in place, :func:`gather_params` rebuilds the full
  tensors (for saves) and :func:`shard_tensors` slices full ones (for
  loads). A layer whose weight holds a slice computes its output channels
  and gathers them over the :class:`TpAxis` that :func:`tp_active` makes
  current (:func:`all_gather_tp`, column parallelism: every next layer
  reads the full, replicated activations, as GSPMD gives for
  ``param_spec``'s tree); its input passes :func:`tp_copy`, whose
  backward sums the input's gradient over the tp group.

Gradients under ``sp``: each rank backpropagates the global loss through
its slab, so its gradient is its slab's share; the train step sums the
shares over ``sp`` and averages over ``data`` in one all-reduce over the
world (sum ÷ data). Under ``tp`` a sharded parameter's gradient is its
slice's, reduced over the rank's replica group (the data·sp ranks of its
tp index); the replicated parameters' gradients, equal on the ranks of a
tp group, are reduced over the world (sum ÷ data·tp), so they stay the
same bits on every rank. ``batch_spec``, ``batch_sharding`` and
``replicated`` describe XLA shardings and have no counterpart.

``FAST_CWDM_DIST_BACKEND`` (``gloo`` or ``nccl``) overrides the backend:
NCCL refuses two ranks on one GPU, gloo takes them (its collectives are
staged through host memory here).
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import gc
import os
import signal
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from fast_cwdm_tpu_torch import resolve_device

DATA_AXIS = "data"
SPATIAL_AXIS = "sp"
TENSOR_AXIS = "tp"
RENDEZVOUS_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


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
        with _sigterm_blocked():
            dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                                    f"{env['MASTER_PORT']}", world_size=world, rank=rank)
    return dev


@contextlib.contextmanager
def _sigterm_blocked():
    """Block SIGTERM in this thread while process groups start: the threads
    they start (gloo's I/O loop and workers, the store's) inherit the mask,
    so that a preemption signal lands on the main thread (training/loop.py's
    handler) and never interrupts a system call of theirs."""
    mask = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
    try:
        yield
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, mask)


class CommLog:
    """Bytes and milliseconds of collectives by kind (``"allreduce"``: the
    gradient all-reduce; ``"halo"``: the sp halo exchanges; ``"sp_reduce"``:
    the sp statistics and loss sums; ``"sp_gather"``: the sp gathers;
    ``"tp_gather"``: the tp axis's channel gathers; ``"tp_reduce"``: the
    sums of a sharded layer's input gradient over the tp group), read
    by the training loop and the chip smoke test. On NCCL the time is taken
    with CUDA events around the collective, without a synchronisation (it
    is read at :meth:`drain`); through gloo and on the CPU with the host
    clock, between synchronisations."""

    def __init__(self):
        self._records: list = []

    def add(self, n_bytes: int, ms, kind: str = "allreduce") -> None:
        self._records.append((kind, n_bytes, ms))

    def drain(self, kind: str | None = "allreduce") -> list[tuple[int, float]]:
        """``(bytes, ms)`` of each call of ``kind`` (every kind: None) since
        the last drain; the other kinds' records are dropped too."""
        out = []
        for k, n_bytes, ms in self._records:
            if kind is not None and k != kind:
                continue
            if isinstance(ms, tuple):
                ms[1].synchronize()
                ms = ms[0].elapsed_time(ms[1])
            out.append((n_bytes, float(ms)))
        self._records = []
        return out

    def move_to(self, other: "CommLog") -> None:
        """Hand every record to ``other`` (unread: no synchronisation)."""
        other._records.extend(self._records)
        self._records = []

    def drain_by_kind(self) -> dict[str, tuple[int, float, int]]:
        """``{kind: (bytes, ms, calls)}`` summed since the last drain."""
        out: dict = {}
        for k, n_bytes, ms in self._records:
            if isinstance(ms, tuple):
                ms[1].synchronize()
                ms = ms[0].elapsed_time(ms[1])
            b, m, n = out.get(k, (0, 0.0, 0))
            out[k] = (b + n_bytes, m + float(ms), n + 1)
        self._records = []
        return out


@dataclass(frozen=True, eq=False)
class SpAxis:
    """One rank's view of its sp group: the ``group`` (a process group),
    its ``size`` and this rank's ``rank`` in it (slab ``rank`` of ``size``
    equal slabs of Y), and the ``log`` its collectives write to."""

    group: object
    size: int
    rank: int
    log: CommLog = field(default_factory=CommLog)


@dataclass(frozen=True, eq=False)
class TpAxis:
    """One rank's view of its tp group: the ``group``, its ``size`` and
    this rank's ``rank`` in it (slice ``rank`` of ``size`` equal slices of
    every sharded output-channel axis), and the ``log`` its gathers write
    to."""

    group: object
    size: int
    rank: int
    log: CommLog = field(default_factory=CommLog)


@dataclass(frozen=True)
class DataMesh:
    """The ``(data, sp, tp)`` mesh: ``shape`` as the JAX mesh's (``{"data":
    D, "sp": S}``, with ``"tp": T`` only where T > 1); ``group``, the
    data-axis group of this rank (None where the data axis has one rank:
    its collectives are the identity); ``rank``, this rank's data index;
    ``sp_axis``, its sp group (None where S == 1); ``world``, the whole
    process group (None in a single process); ``process_rank``, the global
    rank (``(rank·S + sp_rank)·T + tp_rank``); ``tp_axis``, its tp group
    (None where T == 1); ``replica``, the group of the data·sp ranks that
    hold the same tp slices (None where that is this rank alone; the world
    where T == 1)."""

    shape: dict
    group: object
    rank: int
    sp_axis: SpAxis | None = None
    world: object = None
    process_rank: int = 0
    tp_axis: TpAxis | None = None
    replica: object = None

    @property
    def size(self) -> int:
        """Ranks on the data axis."""
        return self.shape[DATA_AXIS]

    @property
    def sp(self) -> int:
        return self.shape[SPATIAL_AXIS]

    @property
    def sp_rank(self) -> int:
        return self.sp_axis.rank if self.sp_axis is not None else 0

    @property
    def sp_group(self):
        return self.sp_axis.group if self.sp_axis is not None else None

    @property
    def tp(self) -> int:
        return self.shape.get(TENSOR_AXIS, 1)

    @property
    def tp_rank(self) -> int:
        return self.tp_axis.rank if self.tp_axis is not None else 0


_MESHES: dict = {}


def _release_groups() -> None:
    """At interpreter exit (registered by the first mesh over a process
    group): take the process groups out of every cached mesh, destroy the
    default group if it is still up, and free the groups while Python
    still runs. A gloo group that a caller's mesh or training loop keeps to
    the end is otherwise freed during interpreter finalization, which can
    abort the process ("terminate called without an active exception")."""
    for mesh in _MESHES.values():
        object.__setattr__(mesh, "group", None)
        object.__setattr__(mesh, "world", None)
        object.__setattr__(mesh, "replica", None)
        for axis in (mesh.sp_axis, mesh.tp_axis):
            if axis is not None:
                object.__setattr__(axis, "group", None)
    _MESHES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def make_mesh(data: int = -1, sp: int = 1, tp: int = 1) -> DataMesh:
    """The ``(data, sp, tp)`` mesh of the process group. ``data=-1`` is the
    world size over ``sp·tp``; ``data·sp·tp`` must be the world size (one
    process per GPU cannot pin a sub-mesh as the JAX package does): more
    raises ``ValueError`` ("exceeds"), as does a world that ``sp·tp`` does
    not divide.

    Collective on first use: every rank builds the groups of every axis in
    the same order (one per data index for sp, and so on). Cached per
    process group, so a later call returns the same groups."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if sp < 1 or tp < 1 or (data != -1 and data < 1):
        raise ValueError(f"make_mesh: data, sp and tp must be positive, got data={data}, "
                         f"sp={sp}, tp={tp}")
    if data == -1:
        if world % (sp * tp):
            raise ValueError(f"{world} rank(s) not divisible by sp*tp={sp * tp}")
        data = world // (sp * tp)
    want = data * sp * tp
    if want > world:
        raise ValueError(
            f"mesh data*sp*tp={want} exceeds the {world} rank(s) of the process group (launch "
            f"torchrun --nproc_per_node={want}, or pass data=-1)")
    if want != world:
        raise ValueError(
            f"mesh data*sp*tp={want} but the process group has {world} rank(s): the mesh spans "
            f"every rank (launch torchrun --nproc_per_node={want}, or pass data=-1)")
    key = (id(dist.group.WORLD) if up else None, data, sp, tp)
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank() if up else 0
    d_idx, s_idx, t_idx = rank // (sp * tp), (rank // tp) % sp, rank % tp
    data_group = sp_group = tp_group = replica = None
    if up and sp == tp == 1:
        data_group = replica = dist.group.WORLD
    elif up:
        # process (d, s, t) is rank (d·sp + s)·tp + t; new_group is
        # collective: every rank makes every group, in the same order
        def ranks(ds=range(data), ss=range(sp), ts=range(tp)):
            return [(d * sp + s) * tp + t for d in ds for s in ss for t in ts]

        with _sigterm_blocked():
            # the data axis: one group per (sp, tp) index
            for s in range(sp):
                for t in range(tp):
                    g = dist.new_group(ranks(ss=[s], ts=[t])) if data > 1 else None
                    if (s_idx, t_idx) == (s, t):
                        data_group = g
            # the sp axis: one group per (data, tp) index
            for d in range(data) if sp > 1 else ():
                for t in range(tp):
                    g = dist.new_group(ranks(ds=[d], ts=[t]))
                    if (d_idx, t_idx) == (d, t):
                        sp_group = g
            if tp > 1:
                # the tp axis: one group per (data, sp) index; the replica
                # groups: one per tp index
                for d in range(data):
                    for s in range(sp):
                        g = dist.new_group(ranks(ds=[d], ss=[s]))
                        if (d_idx, s_idx) == (d, s):
                            tp_group = g
                for t in range(tp) if data * sp > 1 else ():
                    g = dist.new_group(ranks(ts=[t]))
                    if t_idx == t:
                        replica = g
            else:
                replica = dist.group.WORLD
    shape = {DATA_AXIS: data, SPATIAL_AXIS: sp, **({TENSOR_AXIS: tp} if tp > 1 else {})}
    mesh = DataMesh(shape, data_group, d_idx,
                    SpAxis(sp_group, sp, s_idx) if sp > 1 else None,
                    dist.group.WORLD if up else None, rank,
                    TpAxis(tp_group, tp, t_idx) if tp > 1 else None, replica)
    if up:
        atexit.unregister(_release_groups)  # registered once
        atexit.register(_release_groups)
    _MESHES[key] = mesh
    return mesh


def make_hybrid_mesh(sp: int = 1) -> DataMesh:
    """The same as :func:`make_mesh`: under torchrun the data axis spans the
    hosts as it is, and an sp group is consecutive ranks (one host's GPUs
    when ``sp`` divides the GPUs per host)."""
    return make_mesh(sp=sp)


def local_batch_size(global_batch: int, mesh: DataMesh) -> int:
    """Rows of ``global_batch`` each data index holds."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {mesh.size}")
    return global_batch // mesh.size


def local_batch_rows(mesh: DataMesh, global_batch: int) -> tuple[int, int]:
    """This rank's contiguous ``[start, stop)`` rows of a ``global_batch``-row
    batch, by its data index (the ranks of an sp group hold the same rows).
    Every rank builds the same seeded case order and decodes only these
    rows of each batch."""
    b = local_batch_size(global_batch, mesh)
    return mesh.rank * b, (mesh.rank + 1) * b


def y_slab(mesh_or_axis, n: int) -> tuple[int, int]:
    """This rank's ``[start, stop)`` of a Y axis of ``n``: slab ``sp_rank``
    of ``sp`` equal ones (``n`` must divide)."""
    axis = mesh_or_axis.sp_axis if isinstance(mesh_or_axis, DataMesh) else mesh_or_axis
    if axis is None:
        return 0, n
    if n % axis.size:
        raise ValueError(f"Y = {n} does not split into {axis.size} equal sp slabs")
    m = n // axis.size
    return axis.rank * m, (axis.rank + 1) * m


def shard_batch(mesh: DataMesh, tree, *, global_batch: int | None = None,
                device: str | torch.device | None = None):
    """This rank's rows of a batch (a dict of arrays or tensors, or one), and
    under ``sp`` its Y slab (axis 2 of every leaf with more than two axes,
    as the JAX package's ``batch_spec``), on ``device`` (default ``cuda``).
    ``tree`` holds the GLOBAL batch, or, with ``global_batch``, only this
    data index's rows already (the multi-host input contract: each rank
    decodes its own rows, whole volumes)."""
    from fast_cwdm_tpu_torch.data.loader import to_device

    leaves = tree.values() if isinstance(tree, dict) else [tree]
    n = {len(v) for v in leaves}
    if len(n) != 1:
        raise ValueError(f"batch leaves disagree on their row count: {sorted(n)}")
    (n,) = n
    if global_batch is None:
        lo, hi = local_batch_rows(mesh, n)
    elif n != local_batch_size(global_batch, mesh):
        raise ValueError(f"a rank feeds {local_batch_size(global_batch, mesh)} of "
                         f"{global_batch} rows; got {n}")
    else:
        lo, hi = 0, n

    def take(v):
        v = v[lo:hi]
        if mesh.sp > 1 and v.ndim > 2:
            y0, y1 = y_slab(mesh, v.shape[2])
            v = v[:, :, y0:y1]
        return v

    tree = {k: take(v) for k, v in tree.items()} if isinstance(tree, dict) else take(tree)
    return to_device(tree, resolve_device(device))


# -- collectives -------------------------------------------------------------


def _staged(group) -> bool:
    """gloo runs on host tensors: collectives copy through host memory."""
    return dist.get_backend(group) == "gloo"


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` (on the card) in page-locked host memory, for gloo: the copy
    runs at the bus's rate, and the buffer comes from the caching host
    allocator."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _logged(log: CommLog | None, kind: str, n_bytes: int, t: torch.Tensor, staged: bool):
    """Time the collective inside the block into ``log``: CUDA events on an
    unstaged CUDA tensor, else the host clock after a synchronisation."""
    if log is None:
        yield
        return
    if t.is_cuda and not staged:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        log.add(n_bytes, (start, end), kind)
        return
    _sync(t)
    t0 = time.perf_counter()
    yield
    _sync(t)
    log.add(n_bytes, (time.perf_counter() - t0) * 1e3, kind)


def _all_reduce_(group, t: torch.Tensor, log=None, kind="allreduce",
                 op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Replace the contiguous ``t`` by its sum (or ``op``) over ``group``;
    returns it."""
    staged = _staged(group)
    with _logged(log, kind, t.numel() * t.element_size(), t, staged):
        if staged and t.is_cuda:
            host = _pinned_copy(t)
            dist.all_reduce(host, op=op, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=group)
    return t


def _all_reduce(group, t: torch.Tensor, log=None, kind="allreduce") -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor on ``t``'s device."""
    return _all_reduce_(group, t.detach().clone(memory_format=torch.contiguous_format), log,
                        kind)


def _all_gather(group, size: int, t: torch.Tensor, log=None, kind="sp_gather") -> list:
    """``t`` of every rank of ``group`` (equal shapes), in group-rank order
    (this rank's is ``t`` itself, detached)."""
    staged = _staged(group)
    src = t.detach().contiguous()
    with _logged(log, kind, src.numel() * src.element_size() * (size - 1), src, staged):
        if staged and src.is_cuda:
            host = _pinned_copy(src)
            parts = [torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                     for _ in range(size)]
            dist.all_gather(parts, host, group=group)
            me = dist.get_rank(group)
            parts = [src if i == me else p.to(t.device, non_blocking=True)
                     for i, p in enumerate(parts)]
        else:
            parts = [torch.empty_like(src) for _ in range(size)]
            dist.all_gather(parts, src, group=group)
    return parts


def all_reduce_mean_(mesh: DataMesh, tensors: list[torch.Tensor],
                     log: CommLog | None = None, *, replicated: int = 0,
                     sharded: int = 0) -> None:
    """Replace each of ``tensors`` (float32, on one device) by its mean over
    the data axis of its sum over the sp axis, in place: the gradients, of
    which each rank of an sp group holds its slab's share. The last
    ``replicated`` tensors are held whole by every rank of an sp group (the
    loss and the metrics): they are scaled by 1/sp first, so they come out
    as their data-axis mean. The first ``sharded`` tensors are this rank's
    tp slices: one all-reduce over the replica group (sum ÷ data). The
    others, equal on the ranks of a tp group: one all-reduce of a flat
    buffer over the world (sum ÷ data·tp). Every rank of a reducing group
    ends with the same bits."""
    if mesh.world is None or not tensors:
        return
    if sharded:
        flat = torch.cat([t.reshape(-1) for t in tensors[:sharded]])
        if mesh.replica is not None:
            _all_reduce_(mesh.replica, flat, log, "allreduce")
        flat.div_(mesh.size)
        _unflatten(flat, tensors[:sharded])
        tensors = tensors[sharded:]
        if not tensors:
            return
    parts = [t.reshape(-1) for t in tensors]
    if replicated and mesh.sp > 1:
        parts[-replicated:] = [p / mesh.sp for p in parts[-replicated:]]
    flat = _all_reduce_(mesh.world, torch.cat(parts), log, "allreduce")
    flat.div_(mesh.size * mesh.tp)
    _unflatten(flat, tensors)


def _unflatten(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()


def all_gather_rows(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """Every data index's ``x`` (equal shapes) concatenated along dim 0 in
    data order, on every rank."""
    if mesh.group is None:
        return x
    return torch.cat(_all_gather(mesh.group, mesh.size, x))


def any_rank(mesh: DataMesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any (over the world)."""
    if mesh.world is None:
        return bool(flag)
    dev = "cpu" if _staged(mesh.world) else torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.world)
    return bool(t.item())


def gather_metrics(mesh: DataMesh, metrics: dict, per_sample: tuple[str, ...],
                   y_axis: dict | None = None) -> dict:
    """``metrics`` on the host as numpy: the ``y_axis`` leaves (``{key:
    axis}``, image panels of this rank's Y slab) gathered along that axis
    over the sp group, then the ``per_sample`` ones and the panels (rows of
    this rank's batch) gathered across the data axis in order. Collective:
    every rank calls it at the same steps."""
    out = {}
    y_axis = y_axis or {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            if k in y_axis:
                v = all_gather_sp(v.detach(), y_axis[k], mesh.sp_axis)
            if k in per_sample:
                v = all_gather_rows(mesh, v)
            v = v.detach().cpu().numpy()
        out[k] = v
    return out


# -- the sp axis ---------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("fast_cwdm_sp", default=None)


def current_sp() -> SpAxis | None:
    """The sp axis the running code is sharded over (None: whole volumes,
    or a replicated region of the network)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sp_active(axis: SpAxis | None):
    """Run the block with ``axis`` current (None: unsharded)."""
    if axis is not None and axis.size == 1:
        axis = None
    token = _ACTIVE.set(axis)
    try:
        yield axis
    finally:
        _ACTIVE.reset(token)


def bind_axes(fn):
    """``fn`` run under the sp and tp axes current NOW, wherever it is
    called later (a checkpointed block's recomputation runs in the backward
    pass, where no axis is current: every rank must issue the block's
    collectives again, in the same order)."""
    sp, tp = current_sp(), current_tp()

    def bound(*args, **kwargs):
        with sp_active(sp), tp_active(tp):
            return fn(*args, **kwargs)

    return bound


def _axis(axis):
    axis = current_sp() if axis is None else axis
    return axis if axis is not None and axis.size > 1 else None


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, width):
        ctx.axis, ctx.dim, ctx.width = axis, dim, width
        n, r, s = x.shape[dim], axis.rank, axis.size
        if n < width:
            raise ValueError(f"halo_exchange: a slab of {n} planes cannot give {width}")
        parts = _all_gather(axis.group, s, torch.cat(
            [x.narrow(dim, 0, width), x.narrow(dim, n - width, width)], dim), axis.log, "halo")
        pieces = ([parts[r - 1].narrow(dim, width, width)] if r > 0 else []) + [x] + (
            [parts[r + 1].narrow(dim, 0, width)] if r < s - 1 else [])
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, w = ctx.axis, ctx.dim, ctx.width
        r, s = axis.rank, axis.size
        lo, hi = (w if r > 0 else 0), (w if r < s - 1 else 0)
        n = g.shape[dim] - lo - hi
        zero = g.new_zeros(tuple(w if d == dim else k for d, k in enumerate(g.shape)))
        parts = _all_gather(axis.group, s, torch.cat(
            [g.narrow(dim, 0, w) if lo else zero, g.narrow(dim, lo + n, w) if hi else zero],
            dim), axis.log, "halo")
        gx = g.narrow(dim, lo, n).clone()
        # my first planes were rank r-1's upper halo, my last rank r+1's lower
        if r > 0:
            gx.narrow(dim, 0, w).add_(parts[r - 1].narrow(dim, w, w))
        if r < s - 1:
            gx.narrow(dim, n - w, w).add_(parts[r + 1].narrow(dim, 0, w))
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, width: int = 1,
                  axis: SpAxis | None = None) -> tuple[torch.Tensor, int, int]:
    """``(ext, lo, hi)``: ``x`` with the neighbours' ``width`` boundary
    planes of ``dim`` added on its interior sides (``lo`` planes before,
    ``hi`` after; 0 at the global edges, where the caller pads). One
    all-gather of every rank's first and last planes over the sp group
    (each rank keeps its neighbours'). The backward sends the halo
    gradients back and adds them into the boundary planes. Without an
    active axis: ``(x, 0, 0)``."""
    axis = _axis(axis)
    if axis is None:
        return x, 0, 0
    ext = _HaloExchange.apply(x, axis, dim, width)
    return ext, (width if axis.rank > 0 else 0), (width if axis.rank < axis.size - 1 else 0)


def halo_pad(x: torch.Tensor, dim: int, width: int = 1,
             axis: SpAxis | None = None) -> torch.Tensor:
    """``x`` extended by ``width`` planes on both sides of ``dim``: the
    neighbours' planes inside the volume, zeros at its global edges (the
    zero padding of a SAME convolution, for a conv padded 0 along ``dim``)."""
    ext, lo, hi = halo_exchange(x, dim, width, axis)
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [width - lo, width - hi]
    return torch.nn.functional.pad(ext, pad) if lo < width or hi < width else ext


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(axis.group, x, axis.log, "sp_reduce")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.axis.group, g, ctx.axis.log, "sp_reduce"), None


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(axis.group, x, axis.log, "sp_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum_sp(x: torch.Tensor, axis: SpAxis | None = None) -> torch.Tensor:
    """The sum of ``x`` over the sp group, on every rank; its backward is
    itself. For statistics every rank's slab then reads (GroupNorm's sums):
    each rank's gradient of them is its slab's part, the sum is the whole.
    Without an active axis: ``x``."""
    axis = _axis(axis)
    return x if axis is None else _AllReduceSum.apply(x, axis)


def global_sum_sp(x: torch.Tensor, axis: SpAxis | None = None) -> torch.Tensor:
    """The sum of ``x`` over the sp group, on every rank, whose gradient
    reaches this rank's term unchanged: for the loss, which every rank of
    the group holds whole and backpropagates (its gradients are then its
    slab's share of the global loss's). Without an active axis: ``x``."""
    axis = _axis(axis)
    return x if axis is None else _GlobalSum.apply(x, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return torch.cat(_all_gather(axis.group, axis.size, x, axis.log), dim)

    @staticmethod
    def backward(ctx, g):
        # the gathered tensor feeds a region every rank computes whole and
        # backpropagates only through its own slab's outputs: the gradient
        # is the sum of the ranks' parts, of which this rank takes its slab
        g = _all_reduce(ctx.axis.group, g, ctx.axis.log, "sp_reduce")
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _LocalSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        n = x.shape[dim] // axis.size
        ctx.axis, ctx.dim, ctx.n, ctx.shape = axis, dim, n, x.shape
        return x.narrow(dim, axis.rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).copy_(g)
        return out, None, None


def all_gather_sp(x: torch.Tensor, dim: int, axis: SpAxis | None = None) -> torch.Tensor:
    """The whole tensor from every rank's slab of ``dim`` (equal slabs), on
    every rank. Backward: the gradient summed over the group, this rank's
    slab of it. Without an active axis: ``x``."""
    axis = _axis(axis)
    return x if axis is None else _AllGather.apply(x, axis, dim)


def local_slab(x: torch.Tensor, dim: int, axis: SpAxis | None = None) -> torch.Tensor:
    """This rank's slab of ``dim`` of a tensor every rank holds whole (the
    inverse of :func:`all_gather_sp`, no communication). Backward: the
    slab's gradient in place, zeros elsewhere. Without an active axis:
    ``x``."""
    axis = _axis(axis)
    if axis is None:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError(f"local_slab: {x.shape[dim]} planes do not split into {axis.size} slabs")
    return _LocalSlab.apply(x, axis, dim)


# -- the tp axis ---------------------------------------------------------------

_TP: contextvars.ContextVar = contextvars.ContextVar("fast_cwdm_tp", default=None)


def current_tp() -> TpAxis | None:
    """The tp axis the running code gathers its sharded layers over (None:
    no tp axis)."""
    return _TP.get()


@contextlib.contextmanager
def tp_active(axis: TpAxis | None):
    """Run the block with ``axis`` current (None: no tp axis)."""
    if axis is not None and axis.size == 1:
        axis = None
    token = _TP.set(axis)
    try:
        yield axis
    finally:
        _TP.reset(token)


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        last = x.movedim(dim, -1)
        if last.is_contiguous():
            # channels-last memory (or the last dim): gather in that layout,
            # so the full tensor keeps it
            parts = _all_gather(axis.group, axis.size, last, axis.log, "tp_gather")
            return torch.cat(parts, -1).movedim(-1, dim)
        return torch.cat(_all_gather(axis.group, axis.size, x, axis.log, "tp_gather"), dim)

    @staticmethod
    def backward(ctx, g):
        # every rank of the tp group computes the same loss from the same
        # gathered tensor, so each holds the whole gradient: its slice is
        # this rank's part (a sum over the group would give tp times it)
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.axis.group, g, ctx.axis.log, "tp_reduce"), None


def tp_copy(x: torch.Tensor, axis: TpAxis | None) -> torch.Tensor:
    """``x``, the replicated input of a layer that computes a tp slice of
    its outputs; its backward sums the gradient over the tp group (each
    rank's gradient of ``x`` is its slice's part). Where ``x`` needs no
    gradient, or without an axis: ``x``."""
    if axis is None or axis.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _TpCopy.apply(x, axis)


def all_gather_tp(x: torch.Tensor, dim: int, axis: TpAxis | None = None) -> torch.Tensor:
    """Every tp rank's slice of ``dim`` (equal slices) concatenated in tp
    order, on every rank, in ``x``'s memory layout. Backward: this rank's
    slice of the gradient. Without an active axis: ``x``."""
    axis = current_tp() if axis is None else axis
    if axis is None or axis.size == 1:
        return x
    return _TpGather.apply(x, axis, dim % x.dim())


def tp_shard_axis(n_local: int, n_full: int) -> TpAxis | None:
    """The tp axis over which a layer whose output has ``n_full`` channels
    and whose weight holds ``n_local`` of them gathers its output; None
    where the weight is whole. A slice without an active tp axis of the
    matching size raises ``RuntimeError``."""
    if n_local == n_full:
        return None
    axis = current_tp()
    if axis is None or n_local * axis.size != n_full:
        raise RuntimeError(
            f"a layer holds {n_local} of its {n_full} output channels (shard_params) but the "
            f"active tp axis is {None if axis is None else axis.size}: run it under "
            "tp_active(mesh.tp_axis)")
    return axis


def tp_slice(t: torch.Tensor, axis: TpAxis, dim: int = 0) -> torch.Tensor:
    """This rank's slice of ``dim`` of a tensor every rank holds whole."""
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * n, n)


def _output_axis(module: torch.nn.Module) -> tuple[int, int] | None:
    """``(torch axis, full length)`` of the output channels of a module's
    weight: the axis that is the last of the JAX package's flax leaf (conv
    ``(*k, I, O)``, Dense ``(I, O)``, Embed ``(num, features)``). None for
    modules without one (GroupNorm's 1-D parameters)."""
    if isinstance(module, torch.nn.Embedding):
        return 1, module.embedding_dim
    if isinstance(module, torch.nn.Linear):
        return 0, module.out_features
    if isinstance(module, torch.nn.modules.conv._ConvNd):
        return 0, module.out_channels
    return None


def _owned_params(model: torch.nn.Module):
    """``(name, module, parameter name, parameter)`` of every parameter, by
    its ``named_parameters`` name (a shared one once)."""
    seen = set()
    for prefix, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if id(p) not in seen:
                seen.add(id(p))
                yield (f"{prefix}.{pname}" if prefix else pname), module, pname, p


def _spec(module, pname: str, p: torch.Tensor, tp: int) -> int | None:
    out = _output_axis(module)
    if tp < 2 or out is None or p.dim() < 2 or pname != "weight":
        return None
    axis, full = out
    return axis if full % tp == 0 else None


def param_spec(model: torch.nn.Module, name: str, mesh: DataMesh) -> int | None:
    """The torch axis of parameter ``name`` of ``model`` that the mesh's tp
    axis shards (None: replicated). The JAX package's rule on its flax
    layout: a leaf of two or more axes whose last (output-channel) axis tp
    divides is sharded along it; 1-D parameters (biases, GroupNorm scales)
    stay replicated. In the torch layout that axis is dim 0 of a conv or
    ``Linear`` weight and dim 1 of an ``nn.Embedding`` weight."""
    for n, module, pname, p in _owned_params(model):
        if n == name:
            return _spec(module, pname, p, mesh.tp)
    raise KeyError(name)


def sharded_params(model: torch.nn.Module) -> dict[str, int]:
    """``{name: torch axis}`` of the parameters that hold a tp slice now
    (after :func:`shard_params`)."""
    out = {}
    for name, module, pname, p in _owned_params(model):
        spec = _output_axis(module)
        if pname == "weight" and spec is not None and p.shape[spec[0]] != spec[1]:
            out[name] = spec[0]
    return out


@torch.no_grad()
def shard_params(mesh: DataMesh, model: torch.nn.Module) -> torch.nn.Module:
    """Keep this rank's tp slice of every parameter :func:`param_spec`
    shards, in place (the same ``nn.Parameter`` objects; a parameter
    already sliced stays as it is); returns ``model``. Without a tp axis:
    ``model`` unchanged."""
    if mesh.tp_axis is None:
        return model
    done = sharded_params(model)
    for name, module, pname, p in _owned_params(model):
        axis = _spec(module, pname, p, mesh.tp)
        if axis is not None and name not in done:
            p.data = tp_slice(p.data, mesh.tp_axis, axis).clone()
    return model


def shard_tensors(mesh: DataMesh, model: torch.nn.Module,
                  tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``tensors`` (full, by ``state_dict`` key: parameters, Adam moments,
    EMA shadows) with this rank's tp slice, along the axis of
    :func:`sharded_params`, of every one whose key is a sharded parameter
    of ``model`` (a full tensor of another shape raises ``ValueError``);
    the others as they are."""
    if mesh.tp_axis is None:
        return tensors
    params = dict(model.named_parameters())
    axes = {id(params[k]): a for k, a in sharded_params(model).items()}
    local = model.state_dict(keep_vars=True)
    out = {}
    for k, v in tensors.items():
        t = local.get(k)
        dim = None if t is None else axes.get(id(t))
        if dim is None:
            out[k] = v
            continue
        want = list(t.shape)
        want[dim] *= mesh.tp
        if list(v.shape) != want:
            raise ValueError(f"{k}: a tensor of shape {tuple(v.shape)} is not the full "
                             f"{tuple(want)} of the model's tp={mesh.tp} slice {tuple(t.shape)}")
        out[k] = tp_slice(v, mesh.tp_axis, dim).contiguous()
    return out


def gather_params(mesh: DataMesh, model: torch.nn.Module,
                  tensors: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """The full tensors of ``tensors`` (by parameter name; default the
    model's parameters): every name sharded in ``model`` gathered over the
    tp group in one all-gather of a flat buffer, the others as they are.
    Collective over the tp group."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    axis = mesh.tp_axis
    axes = sharded_params(model) if axis is not None else {}
    names = [k for k in tensors if k in axes]
    if not names:
        return dict(tensors)
    flat = torch.cat([tensors[k].detach().reshape(-1) for k in names])
    parts = _all_gather(axis.group, axis.size, flat, axis.log, "tp_gather")
    out, offset = dict(tensors), 0
    for k in names:
        t = tensors[k]
        out[k] = torch.cat([p[offset: offset + t.numel()].view(t.shape) for p in parts], axes[k])
        offset += t.numel()
    return out


def max_over_tp(mesh: DataMesh | None, t: torch.Tensor) -> torch.Tensor:
    """The maximum of ``t`` over the tp group (a norm of sharded tensors);
    ``t`` where there is no tp axis."""
    if mesh is None or mesh.tp_axis is None:
        return t
    return _all_reduce_(mesh.tp_axis.group, t.detach().clone(), op=dist.ReduceOp.MAX)
