"""Wrapper of the CUDA kernel K3: fused per-channel affine + SiLU.

Counterpart of ``fast_cwdm_tpu/ops/elementwise_pallas.py``. GroupNorm-apply
followed by SiLU collapses into ``y = silu(x·a + b)`` with per-(batch,
channel) ``a = rstd·scale`` and ``b = bias − mean·a``, so the activation is
read once and written once (``ops/csrc/affine_silu.cu``).

Tensors are logical NCDHW ``(B, C, *spatial)``, as inside the UNet, stored
contiguous or ``channels_last_3d``. The math is fp32 and the result is
rounded once to ``x``'s dtype. A CPU tensor takes the plain torch version;
a CUDA tensor launches the kernel or raises. ``affine_silu.launches``
counts kernel launches. No backward kernel yet (inference path).
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("affine_silu")
    lib.affine_silu.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.affine_silu.restype = ctypes.c_int
    return lib


def affine_silu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3: ``silu(x·a + b)``; x (B, C, *spatial), a and b (B, C) float32."""
    if x.dim() < 3:
        raise ValueError(f"affine_silu: need (B, C, *spatial), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return affine_silu_plain(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"affine_silu: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"affine_silu: the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    bsz, c = x.shape[:2]
    for name, p in (("a", a), ("b", b)):
        if p.shape != (bsz, c) or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(
                f"affine_silu: {name} must be float32 ({bsz}, {c}) on {x.device}, "
                f"got {p.dtype} {tuple(p.shape)} on {p.device}"
            )
    if x.is_contiguous():
        channels_last = 0
    elif x.dim() == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
        channels_last = 1
    else:
        raise ValueError(
            "affine_silu: the CUDA kernel takes contiguous or channels_last_3d "
            f"tensors, got strides {x.stride()}"
        )
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


affine_silu.launches = 0


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
