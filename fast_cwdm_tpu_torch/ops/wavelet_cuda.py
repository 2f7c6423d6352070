"""Wrappers of the CUDA Haar kernels K1 (DWT) and K2 (IDWT).

Counterpart of ``fast_cwdm_tpu/ops/wavelet_pallas.py``. The kernels live in
``ops/csrc/haar3d.cu``; both work in the flat band-last layout:

    haar_dwt3:  (..., X, Y, Z)          → (..., X/2, Y/2, Z/2, 8)
    haar_idwt3: (..., X/2, Y/2, Z/2, 8) → (..., X, Y, Z)

A CPU tensor takes the plain torch version beside each kernel; a CUDA
tensor launches the kernel or raises. ``haar_dwt3.launches`` and
``haar_idwt3.launches`` count kernel launches.

The transform is orthonormal, so the gradient of the DWT is the IDWT of
the cotangent and vice versa: :class:`HaarDWT3` and :class:`HaarIDWT3`
launch the other kernel in their backward.
"""

from __future__ import annotations

import ctypes

import torch

from fast_cwdm_tpu_torch.ops import _build
from fast_cwdm_tpu_torch.ops import wavelet as wv


def haar_dwt3_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1."""
    return wv.dwt3(x[..., None], "haar")[..., 0]


def haar_idwt3_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K2."""
    return wv.idwt3(y[..., None], "haar")[..., 0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("haar3d")
    for fn in (lib.haar_dwt3_f32, lib.haar_idwt3_f32):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes contiguous tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the CUDA kernel needs a 16-byte aligned tensor")


def haar_dwt3(x: torch.Tensor) -> torch.Tensor:
    """K1: Haar DWT of ``(..., X, Y, Z)`` into ``(..., X/2, Y/2, Z/2, 8)``."""
    if x.dim() < 3 or any(s % 2 for s in x.shape[-3:]):
        raise ValueError(f"haar_dwt3: need (..., X, Y, Z) with even sizes, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return haar_dwt3_plain(x)
    _check_cuda(x, "haar_dwt3")
    xh, yh, zh = (s // 2 for s in x.shape[-3:])
    batch = x.numel() // (8 * xh * yh * zh) if x.numel() else 0
    y = torch.empty((*x.shape[:-3], xh, yh, zh, 8), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _lib().haar_dwt3_f32(
            x.data_ptr(), y.data_ptr(), batch, xh, yh, zh,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "haar_dwt3")
    haar_dwt3.launches += 1
    return y


def haar_idwt3(y: torch.Tensor) -> torch.Tensor:
    """K2: inverse of :func:`haar_dwt3`."""
    if y.dim() < 4 or y.shape[-1] != 8:
        raise ValueError(f"haar_idwt3: need (..., X, Y, Z, 8), got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return haar_idwt3_plain(y)
    _check_cuda(y, "haar_idwt3")
    xh, yh, zh = y.shape[-4:-1]
    batch = y.numel() // (8 * xh * yh * zh) if y.numel() else 0
    x = torch.empty((*y.shape[:-4], 2 * xh, 2 * yh, 2 * zh), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        status = _lib().haar_idwt3_f32(
            y.data_ptr(), x.data_ptr(), batch, xh, yh, zh,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "haar_idwt3")
    haar_idwt3.launches += 1
    return x


haar_dwt3.launches = 0
haar_idwt3.launches = 0


class HaarDWT3(torch.autograd.Function):
    """K1 forward, K2 backward (the DWT's adjoint is its inverse)."""

    @staticmethod
    def forward(ctx, x):
        return haar_dwt3(x)

    @staticmethod
    def backward(ctx, g):
        return haar_idwt3(g.contiguous())


class HaarIDWT3(torch.autograd.Function):
    """K2 forward, K1 backward."""

    @staticmethod
    def forward(ctx, y):
        return haar_idwt3(y)

    @staticmethod
    def backward(ctx, g):
        return haar_dwt3(g.contiguous())
