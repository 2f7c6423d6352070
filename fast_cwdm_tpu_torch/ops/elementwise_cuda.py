"""Wrappers of the CUDA kernel K3: fused per-channel affine + SiLU, of its
VJP, and of GroupNorm's statistics in one pass (``gn_stats``).

Counterpart of ``fast_cwdm_tpu/ops/elementwise_pallas.py``. GroupNorm-apply
followed by SiLU collapses into ``y = silu(x·a + b)`` with per-(batch,
channel) ``a = rstd·scale`` and ``b = bias − mean·a``, so the activation is
read once and written once (``ops/csrc/affine_silu.cu``).

Tensors are logical NCDHW ``(B, C, *spatial)``, as inside the UNet, stored
contiguous or ``channels_last_3d``. The math is fp32 and the result is
rounded once to ``x``'s dtype. A CPU tensor takes the plain torch version;
a CUDA tensor launches the kernel or raises.

:func:`affine_silu` is an ``autograd.Function``, as the JAX package's is a
``custom_vjp``: its backward is the VJP kernel (``affine_silu_bwd``, in the
same source) on the card and :func:`affine_silu_bwd_plain` on the CPU.
``affine_silu.launches`` and ``affine_silu_bwd.launches`` count kernel
launches.

:func:`gn_stats` gives the per-(batch, channel) mean and inverse std of a
GroupNorm's groups (``ops/csrc/gn_stats.cu``: one read of x in its own
dtype, fp32 sums, one launch) where no gradient is needed; under autograd,
and for CPU tensors, the plain torch version runs. ``gn_stats.launches``
counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from fast_cwdm_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def affine_silu_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K3."""
    bc = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    u = x.float() * a.reshape(bc) + b.reshape(bc)
    return (u * torch.sigmoid(u)).to(x.dtype)


def affine_silu_bwd_plain(
    x: torch.Tensor, g: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the K3 VJP (``_affine_silu_bwd`` of the JAX
    package): ``(gx, ga, gb)`` from the saved ``x, a, b`` and the cotangent
    ``g``; gx in ``x``'s dtype, ga and gb (B, C) float32."""
    bc = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    xf, gf = x.float(), g.float()
    a_, b_ = a.reshape(bc), b.reshape(bc)
    u = xf * a_ + b_
    s = torch.sigmoid(u)
    du = gf * (s * (1.0 + u * (1.0 - s)))  # d silu / du
    spatial = tuple(range(2, x.dim()))
    return (du * a_).to(x.dtype), (du * xf).sum(spatial), du.sum(spatial)


def _lib() -> ctypes.CDLL:
    lib = _build.load("affine_silu")
    lib.affine_silu.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.affine_silu.restype = ctypes.c_int
    lib.affine_silu_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.affine_silu_bwd.restype = ctypes.c_int
    return lib


def _memory_format(x: torch.Tensor, what: str) -> int:
    """1 for ``channels_last_3d``, 0 for contiguous; raises otherwise."""
    if x.is_contiguous():
        return 0
    if x.dim() == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
        return 1
    raise ValueError(
        f"{what}: the CUDA kernel takes contiguous or channels_last_3d "
        f"tensors, got strides {x.stride()}"
    )


def _check_cuda_args(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    bsz, c = x.shape[:2]
    for name, p in (("a", a), ("b", b)):
        if p.shape != (bsz, c) or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(
                f"{what}: {name} must be float32 ({bsz}, {c}) on {x.device}, "
                f"got {p.dtype} {tuple(p.shape)} on {p.device}"
            )


def _affine_silu_fwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3 on the card: ``silu(x·a + b)``, one launch."""
    _check_cuda_args(x, a, b, "affine_silu")
    channels_last = _memory_format(x, "affine_silu")
    bsz, c = x.shape[:2]
    a, b = a.contiguous(), b.contiguous()
    y = torch.empty_like(x)  # same strides as x
    spatial = x.numel() // (bsz * c) if x.numel() else 0
    with torch.cuda.device(x.device):
        status = _lib().affine_silu(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            x.numel(), c, spatial, channels_last, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "affine_silu")
    affine_silu.launches += 1
    return y


# CTAs the VJP's first kernel aims for: 8 per SM of an H100
_BWD_TARGET_CTAS = 132 * 8


def bwd_plan(x: torch.Tensor, g: torch.Tensor, gx: torch.Tensor) -> tuple[int, int]:
    """``(vec, chunks)`` of the VJP kernel for these tensors: ``vec`` elements
    per 16-byte vector (1 where the layout or alignment does not allow
    vectors), and ``chunks`` CTAs along the voxels of each (batch, channel)
    row (contiguous) or (batch, channel group) (channels_last_3d), about
    ``_BWD_TARGET_CTAS`` CTAs in all; the partials buffer holds
    ``2 · chunks · B · C`` floats."""
    bsz, c = x.shape[:2]
    s = x.numel() // (bsz * c)
    channels_last = _memory_format(x, "affine_silu_bwd")
    vec = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, gx))
    if not aligned or (c % vec if channels_last else s % vec):
        vec = 1
    if channels_last:
        cv = c // vec
        bdx = min(cv, 256)
        cgroups, bdy = -(-cv // bdx), 256 // bdx
        chunks = min(-(-_BWD_TARGET_CTAS // (cgroups * bsz)), -(-s // bdy))
    else:
        chunks = min(-(-_BWD_TARGET_CTAS // (bsz * c)), -(-(s // vec) // 256))
    return vec, max(1, chunks)


def affine_silu_bwd(
    x: torch.Tensor, g: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K3 VJP: ``(gx, ga, gb)``, as :func:`affine_silu_bwd_plain`. A CPU
    tensor takes the plain version; on the card ``g`` is brought to ``x``'s
    memory format and dtype and the kernel runs (two launches: the pass and
    the fixed-order sum of its partials)."""
    if x.dim() < 3:
        raise ValueError(f"affine_silu_bwd: need (B, C, *spatial), got {tuple(x.shape)}")
    if g.shape != x.shape:
        raise ValueError(f"affine_silu_bwd: g {tuple(g.shape)} and x {tuple(x.shape)} differ")
    if x.device.type == "cpu":
        return affine_silu_bwd_plain(x, g, a, b)
    _check_cuda_args(x, a, b, "affine_silu_bwd")
    channels_last = _memory_format(x, "affine_silu_bwd")
    fmt = torch.channels_last_3d if channels_last else torch.contiguous_format
    g = g.to(x.dtype).contiguous(memory_format=fmt)
    bsz, c = x.shape[:2]
    gx = torch.empty_like(x)
    ga = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    gb = torch.empty_like(ga)
    if x.numel() == 0:
        return gx, ga.zero_(), gb.zero_()
    vec, chunks = bwd_plan(x, g, gx)
    partials = torch.empty(2 * chunks * bsz * c, dtype=torch.float32, device=x.device)
    a, b = a.contiguous(), b.contiguous()
    with torch.cuda.device(x.device):
        status = _lib().affine_silu_bwd(
            x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(), gx.data_ptr(),
            ga.data_ptr(), gb.data_ptr(), partials.data_ptr(), bsz, c,
            x.numel() // (bsz * c), channels_last, vec, chunks, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "affine_silu_bwd")
    affine_silu_bwd.launches += 1
    return gx, ga, gb


class AffineSiLU(torch.autograd.Function):
    """K3 forward, K3 VJP backward (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        if x.device.type == "cpu":
            return affine_silu_plain(x, a, b)
        return _affine_silu_fwd(x, a, b)

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        gx, ga, gb = affine_silu_bwd(x, g, a, b)
        return gx, ga.to(a.dtype), gb.to(b.dtype)


def affine_silu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3: ``silu(x·a + b)``; x (B, C, *spatial), a and b (B, C) float32.
    Differentiable in x, a and b through the K3 VJP."""
    if x.dim() < 3:
        raise ValueError(f"affine_silu: need (B, C, *spatial), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"affine_silu: expected a CPU or CUDA tensor, got {x.device}")
    return AffineSiLU.apply(x, a, b)


affine_silu.launches = 0
affine_silu_bwd.launches = 0


def gn_apply_silu(
    x: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """GroupNorm apply + SiLU in one pass: ``silu((x − mean)·rstd·scale +
    bias)`` with ``mean``/``rstd`` per (B, C) float32 and ``scale``/``bias``
    per channel."""
    a = rstd * scale[None, :]
    b = bias[None, :] - mean * a
    return affine_silu(x, a, b)


# GroupNorm's two statistics formulas (``gn_stats``'s ``formula``): one mean
# over the voxels and the group's channels (``conv3d_cuda.group_stats``, the
# JAX package's ``group_stats``), or the mean of the channel means
# (``models.nn.GroupNorm32``, the JAX module's)
GN_GROUP, GN_CHANNEL_MEANS = 0, 1


def group_norm_inv(mean: torch.Tensor, mean_sq: torch.Tensor,
                   cpg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, G) group E[x] and E[x²] → per-(batch, channel) fp32 ``(mean,
    inv)``, (B, G·cpg): var = max(E[x²] − E[x]², 0), inv = rsqrt(var +
    1e-5)."""
    inv = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + 1e-5)
    return mean.repeat_interleave(cpg, dim=-1), inv.repeat_interleave(cpg, dim=-1)


def gn_stats_plain(x: torch.Tensor, num_groups: int,
                   formula: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the statistics kernel: fp32 ``(mean, inv)``
    (B, C) of ``x`` (B, C, *spatial); a (B, C) ``x`` (no spatial axes) is
    its own channel means under ``GN_CHANNEL_MEANS``."""
    b, c = x.shape[:2]
    g = num_groups
    if formula == GN_GROUP:
        xf = x.float().movedim(1, -1).reshape(b, -1, g, c // g)
        mean, mean_sq = xf.mean(dim=(1, 3)), (xf * xf).mean(dim=(1, 3))
    elif formula == GN_CHANNEL_MEANS:
        xf = x.float()
        spatial = tuple(range(2, x.dim()))
        # torch reads an empty ``dim`` as every axis
        mean_c = xf.mean(dim=spatial) if spatial else xf
        mean_sq_c = (xf * xf).mean(dim=spatial) if spatial else xf * xf
        mean = mean_c.reshape(b, g, c // g).mean(dim=-1)
        mean_sq = mean_sq_c.reshape(b, g, c // g).mean(dim=-1)
    else:
        raise ValueError(f"gn_stats: formula must be GN_GROUP or GN_CHANNEL_MEANS, got {formula!r}")
    return group_norm_inv(mean, mean_sq, c // g)


def _gn_lib() -> ctypes.CDLL:
    lib = _build.load("gn_stats")
    lib.gn_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gn_stats.restype = ctypes.c_int
    return lib


# threads a CTA of the statistics kernel, and the CTAs it aims for: two on
# each SM of an H100 (132), each reading at least GN_MIN_VECTORS vectors a
# thread
GN_THREADS = 512
GN_TARGET_CTAS = 132 * 2
GN_MIN_VECTORS = 8


def gn_channels_last(x: torch.Tensor) -> int:
    """The statistics kernel's layouts: 0 for a contiguous ``x``, 1 for one
    stored channels last, (B, *spatial, C) dense (``channels_last_3d``, or a
    flattened view of it such as the attention block's (B, C, T)); raises
    otherwise, as K3's :func:`_memory_format`."""
    if x.is_contiguous():
        return 0
    if x.movedim(1, -1).is_contiguous():
        return 1
    raise ValueError(
        f"gn_stats: the CUDA kernel takes contiguous or channels-last tensors, got "
        f"strides {x.stride()}"
    )


def gn_stats_plan(x: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """``(channels_last, vec, bdx, bdy, chunks, chunk_len)`` of the
    statistics kernel for ``x``: its layout (:func:`gn_channels_last`);
    ``vec`` elements a 16-byte vector (1 where the layout or
    alignment does not allow vectors); a (bdx, bdy) block, threads along the
    channel vectors of a voxel and along voxels (channels last) or 512
    along a row (contiguous); ``chunks`` CTAs along the voxels of each
    (batch, channel group) or (batch, channel) row, ``chunk_len`` voxels
    (channels last) or vectors (contiguous) each, about
    ``GN_TARGET_CTAS`` CTAs in all. Raises on a layout the kernel does not
    take."""
    bsz, c = x.shape[:2]
    s = x.numel() // (bsz * c)
    channels_last = gn_channels_last(x)
    vec = 16 // x.element_size()
    if x.data_ptr() % 16 or (c % vec if channels_last else s % vec):
        vec = 1
    if channels_last:
        cv = c // vec
        bdx = min(cv, GN_THREADS)
        bdy = GN_THREADS // bdx
        cgroups = -(-cv // bdx)
        chunks = min(-(-GN_TARGET_CTAS // (bsz * cgroups)), -(-s // (bdy * GN_MIN_VECTORS)))
        n = s
    else:
        bdx, bdy = GN_THREADS, 1
        n = s // vec
        chunks = min(-(-GN_TARGET_CTAS // (bsz * c)), -(-n // (GN_THREADS * GN_MIN_VECTORS)))
    chunk_len = -(-n // max(1, chunks))
    return channels_last, vec, bdx, bdy, -(-n // chunk_len), chunk_len


# one ticket counter per device, 0 between launches: the kernel's last CTA
# finds itself by it and returns it to 0
_GN_TICKETS: dict[int, torch.Tensor] = {}


def _gn_ticket(device: torch.device) -> torch.Tensor:
    index = device.index if device.index is not None else torch.cuda.current_device()
    ticket = _GN_TICKETS.get(index)
    if ticket is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "gn_stats: the first launch on a device allocates its ticket counter "
                "and cannot be captured in a CUDA graph; run it once eagerly first")
        ticket = _GN_TICKETS[index] = torch.zeros(1, dtype=torch.int32, device=device)
    return ticket


def _gn_stats_kernel(x: torch.Tensor, num_groups: int,
                     formula: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The statistics kernel on the card: one launch."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gn_stats: the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    bsz, c = x.shape[:2]
    if x.numel() == 0 or c % num_groups or formula not in (GN_GROUP, GN_CHANNEL_MEANS):
        raise ValueError(f"gn_stats: need a nonempty x with C a multiple of num_groups and a "
                         f"known formula, got {tuple(x.shape)}, {num_groups}, {formula!r}")
    channels_last, vec, bdx, bdy, chunks, chunk_len = gn_stats_plan(x)
    mean = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    work = torch.empty(2 * (chunks + 1) * bsz * c, dtype=torch.float32, device=x.device)
    ticket = _gn_ticket(x.device)
    with torch.cuda.device(x.device):
        status = _gn_lib().gn_stats(
            x.data_ptr(), mean.data_ptr(), inv.data_ptr(), work.data_ptr(), ticket.data_ptr(),
            bsz, c, x.numel() // (bsz * c), num_groups, channels_last, vec,
            bdx, bdy, chunks, chunk_len, formula, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "gn_stats")
    gn_stats.launches += 1
    return mean, inv


def gn_stats(x: torch.Tensor, num_groups: int,
             formula: int) -> tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm statistics of ``x`` (B, C, *spatial) in ``num_groups``
    groups: fp32 ``(mean, inv)`` (B, C), each channel holding its group's,
    by ``formula`` (``GN_GROUP`` or ``GN_CHANNEL_MEANS``). A CUDA tensor with
    spatial axes whose statistics autograd will not differentiate (no grad
    mode, or ``x`` not requiring grad) launches the kernel (float32 or
    bfloat16, contiguous or channels last, else it raises); everything
    else, the CPU and training under autograd among it, runs the plain
    version."""
    if x.device.type == "cuda" and x.dim() > 2 and not (
            torch.is_grad_enabled() and x.requires_grad):
        return _gn_stats_kernel(x, num_groups, formula)
    return gn_stats_plain(x, num_groups, formula)


gn_stats.launches = 0
