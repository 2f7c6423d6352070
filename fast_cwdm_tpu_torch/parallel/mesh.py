"""The ``data`` and ``sp`` axes over ``torch.distributed`` (port of
``fast_cwdm_tpu/parallel/mesh.py``).

The JAX package drives N chips from one process: a ``jax.sharding.Mesh``
whose ``data`` axis shards the batch and whose ``sp`` axis shards the Y
axis of every volume (axis 2 of (B, X, Y, Z, C)), with XLA inserting the
gradient ``psum`` and GSPMD the convolutions' halo exchanges. Here it is
one process per GPU, started by ``torchrun``, and every collective is
written out:

* :func:`setup_distributed` joins the process group from torchrun's
  variables (``nccl`` on CUDA, ``gloo`` on the CPU) and pins the rank's GPU;
* :func:`make_mesh` describes the ``(data, sp)`` mesh (:class:`DataMesh`):
  process ``r`` is data index ``r // sp`` and sp index ``r % sp`` (an sp
  group is consecutive ranks, as the JAX mesh's inner axis), every rank
  holds the whole model;
* :func:`local_batch_rows` / :func:`shard_batch` give each data index the
  contiguous rows ``[d·b, (d+1)·b)`` of the global batch, and each sp index
  its Y slab;
* :func:`all_reduce_mean_`, :func:`all_gather_rows` and :func:`any_rank`
  are the collectives the train step, the resampler, the loop and
  synthesis issue by hand;
* the ``sp`` collectives (:func:`halo_exchange`, :func:`all_reduce_sum_sp`,
  :func:`global_sum_sp`, :func:`all_gather_sp`, :func:`local_slab`), each
  an autograd Function, over the :class:`SpAxis` that :func:`sp_active`
  makes current; the UNet's convolutions, GroupNorms, wavelets and the
  losses read it with :func:`current_sp`.

Gradients under ``sp``: each rank backpropagates the global loss through
its slab, so its gradient is its slab's share; the train step sums the
shares over ``sp`` and averages over ``data`` in one all-reduce over the
world (sum ÷ data). The ``tp`` axis is not ported (``NotImplementedError``);
``batch_spec``, ``batch_sharding``, ``replicated``, ``param_spec`` and
``shard_params`` describe XLA shardings and have no counterpart.

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
NOT_PORTED = ("ROADMAP §1 M8: the tp axis is not ported (it needs column-parallel "
              "convs)")


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
    the sp statistics and loss sums; ``"sp_gather"``: the sp gathers), read
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


@dataclass(frozen=True)
class DataMesh:
    """The ``(data, sp)`` mesh: ``shape`` as the JAX mesh's (``{"data": D,
    "sp": S}``); ``group``, the data-axis group of this rank (None where the
    data axis has one rank: its collectives are the identity); ``rank``,
    this rank's data index; ``sp_axis``, its sp group (None where S == 1);
    ``world``, the whole process group (None in a single process);
    ``process_rank``, the global rank (``rank·S + sp_rank``)."""

    shape: dict
    group: object
    rank: int
    sp_axis: SpAxis | None = None
    world: object = None
    process_rank: int = 0

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
        if mesh.sp_axis is not None:
            object.__setattr__(mesh.sp_axis, "group", None)
    _MESHES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def make_mesh(data: int = -1, sp: int = 1, tp: int = 1) -> DataMesh:
    """The ``(data, sp)`` mesh of the process group. ``data=-1`` is the
    world size over ``sp``; ``data·sp`` must be the world size (one process
    per GPU cannot pin a sub-mesh as the JAX package does): more raises
    ``ValueError`` ("exceeds"), as does a world that ``sp`` does not
    divide. ``tp`` > 1 raises ``NotImplementedError``.

    Collective on first use: every rank builds one group per data index
    and one per sp index, in the same order. Cached per process group, so
    a later call returns the same groups."""
    if tp > 1:
        raise NotImplementedError(f"make_mesh(tp={tp}): {NOT_PORTED}")
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if sp < 1 or (data != -1 and data < 1):
        raise ValueError(f"make_mesh: data and sp must be positive, got data={data}, sp={sp}")
    if data == -1:
        if world % sp:
            raise ValueError(f"{world} rank(s) not divisible by sp*tp={sp * tp}")
        data = world // sp
    want = data * sp
    if want > world:
        raise ValueError(
            f"mesh data*sp={want} exceeds the {world} rank(s) of the process group (launch "
            f"torchrun --nproc_per_node={want}, or pass data=-1)")
    if want != world:
        raise ValueError(
            f"mesh data*sp={want} but the process group has {world} rank(s): the mesh spans "
            f"every rank (launch torchrun --nproc_per_node={want}, or pass data=-1)")
    key = (id(dist.group.WORLD) if up else None, data, sp)
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank() if up else 0
    data_group = sp_group = None
    if up and sp == 1:
        data_group = dist.group.WORLD
    elif up:
        # one group per sp index (the data axis), then one per data index
        # (the sp axis): new_group is collective, every rank makes all of them
        with _sigterm_blocked():
            for s in range(sp):
                g = dist.new_group([d * sp + s for d in range(data)]) if data > 1 else None
                if rank % sp == s:
                    data_group = g
            for d in range(data):
                g = dist.new_group([d * sp + s for s in range(sp)])
                if rank // sp == d:
                    sp_group = g
    mesh = DataMesh({DATA_AXIS: data, SPATIAL_AXIS: sp}, data_group, rank // sp,
                    SpAxis(sp_group, sp, rank % sp) if sp > 1 else None,
                    dist.group.WORLD if up else None, rank)
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


def _all_reduce_(group, t: torch.Tensor, log=None, kind="allreduce") -> torch.Tensor:
    """Replace the contiguous ``t`` by its sum over ``group``; returns it."""
    staged = _staged(group)
    with _logged(log, kind, t.numel() * t.element_size(), t, staged):
        if staged and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
    return t


def _all_reduce(group, t: torch.Tensor, log=None, kind="allreduce") -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor on ``t``'s device."""
    return _all_reduce_(group, t.detach().clone(memory_format=torch.contiguous_format), log,
                        kind)


def _all_gather(group, size: int, t: torch.Tensor, log=None, kind="sp_gather") -> list:
    """``t`` of every rank of ``group`` (equal shapes), in group-rank order."""
    staged = _staged(group)
    src = t.detach().contiguous()
    with _logged(log, kind, src.numel() * src.element_size() * (size - 1), src, staged):
        if staged and src.is_cuda:
            host = src.cpu()
            parts = [torch.empty_like(host) for _ in range(size)]
            dist.all_gather(parts, host, group=group)
            parts = [p.to(t.device) for p in parts]
        else:
            parts = [torch.empty_like(src) for _ in range(size)]
            dist.all_gather(parts, src, group=group)
    return parts


def all_reduce_mean_(mesh: DataMesh, tensors: list[torch.Tensor],
                     log: CommLog | None = None, *, replicated: int = 0) -> None:
    """Replace each of ``tensors`` (float32, on one device) by its mean over
    the data axis of its sum over the sp axis, in place, with ONE
    all-reduce of a flat buffer over the world (sum ÷ data): the gradients,
    of which each rank of an sp group holds its slab's share. The last
    ``replicated`` tensors are held whole by every rank of an sp group (the
    loss and the metrics): they are scaled by 1/sp first, so they come out
    as their data-axis mean. Every rank ends with the same bits."""
    if mesh.world is None or not tensors:
        return
    parts = [t.reshape(-1) for t in tensors]
    if replicated and mesh.sp > 1:
        parts[-replicated:] = [p / mesh.sp for p in parts[-replicated:]]
    flat = _all_reduce_(mesh.world, torch.cat(parts), log, "allreduce")
    flat.div_(mesh.size)
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


def bind_sp(fn):
    """``fn`` run under the sp axis current NOW, wherever it is called later
    (a checkpointed block's recomputation runs in the backward pass, where
    no axis is current: every rank must issue the block's collectives
    again, in the same order)."""
    axis = current_sp()

    def bound(*args, **kwargs):
        with sp_active(axis):
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
