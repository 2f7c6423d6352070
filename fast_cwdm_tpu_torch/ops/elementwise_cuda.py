"""Wrapper of the CUDA kernel K3: fused per-channel affine + SiLU, and of
its VJP.

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
