"""3-D discrete wavelet transforms on channels-last tensors.

Port of ``fast_cwdm_tpu/ops/wavelet.py`` (3-D part). Layout is the JAX
package's channels-last ``(..., X, Y, Z, C)``; subband order is LLL, LLH,
LHL, LHH, HLL, HLH, HHL, HHH, i.e. band index = 4*high(X) + 2*high(Y) +
high(Z). Haar runs as paired sums and differences; Daubechies-N as banded
decimated matrices with zero-boundary truncation.

Single-channel Haar transforms of fp32 tensors route to the hand-written
CUDA kernels K1/K2 (``ops/wavelet_cuda.py``), which take their plain torch
versions for CPU tensors. ``impl="xla"`` keeps the name of the JAX option
and always takes the plain path.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

INV_SQRT2 = 1.0 / math.sqrt(2.0)
LLL_SCALE = 3.0
HAAR = ("haar", "db1")


def _daubechies_scaling_filter(n_moments: int) -> np.ndarray:
    """Daubechies scaling filter (pywt ``rec_lo``) with N vanishing moments,
    by spectral factorization of the Bernstein half-band polynomial."""
    if n_moments == 1:
        return np.array([INV_SQRT2, INV_SQRT2], dtype=np.float64)
    n = n_moments
    p = np.array([math.comb(n - 1 + k, k) for k in range(n)], dtype=np.float64)
    z_roots = []
    for y in np.roots(p[::-1]):
        c = 1.0 - 2.0 * y
        d = np.sqrt(c * c - 1.0 + 0j)
        z1, z2 = c + d, c - d
        z_roots.append(z1 if abs(z1) < 1.0 else z2)
    h = np.poly(z_roots).real
    h = np.convolve(h, [math.comb(n, j) for j in range(n + 1)])
    h = h / h.sum() * math.sqrt(2.0)
    if int(np.argmax(np.abs(h))) >= len(h) // 2:
        h = h[::-1]
    return h


@functools.lru_cache(maxsize=None)
def filter_bank(wavelet: str = "haar") -> tuple[np.ndarray, np.ndarray]:
    """``(rec_lo, rec_hi)`` float64 filters of an orthogonal wavelet."""
    name = wavelet.lower()
    if name in HAAR:
        lo = np.array([INV_SQRT2, INV_SQRT2], dtype=np.float64)
    elif name.startswith("db"):
        lo = _daubechies_scaling_filter(int(name[2:]))
    else:
        raise ValueError(f"unsupported wavelet '{wavelet}' (supported: haar, dbN)")
    hi = lo[::-1].copy()  # quadrature mirror: g[k] = (-1)^k h[L-1-k]
    hi[1::2] *= -1.0
    return lo, hi


@functools.lru_cache(maxsize=None)
def _banded_matrices(n: int, wavelet: str) -> tuple[np.ndarray, np.ndarray]:
    """Decimated banded analysis matrices L (n//2, n) and H (n - n//2, n):
    row i applies the filter at offset ``2i - (len//2 - 1)``, positions
    outside [0, n) dropped."""
    lo, hi = filter_bank(wavelet)
    half = len(lo) // 2
    n_lo = n // 2
    mats = (np.zeros((n_lo, n)), np.zeros((n - n_lo, n)))
    for mat, filt in zip(mats, (lo, hi)):
        for i in range(mat.shape[0]):
            for j, w in enumerate(filt):
                col = 2 * i + j - (half - 1)
                if 0 <= col < n:
                    mat[i, col] = w
    return mats


def _every_other(x: torch.Tensor, axis: int, start: int) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, None, 2)
    return x[tuple(idx)]


def _axis_down(x: torch.Tensor, axis: int, wavelet: str):
    """(low, high) halves of ``x`` along ``axis``."""
    if x.shape[axis] % 2:
        raise ValueError(
            f"axis {axis} has odd size {x.shape[axis]}; DWT requires even"
        )
    if wavelet in HAAR:
        even, odd = _every_other(x, axis, 0), _every_other(x, axis, 1)
        return (even + odd) * INV_SQRT2, (even - odd) * INV_SQRT2
    mat_l, mat_h = _banded_matrices(x.shape[axis], wavelet)
    moved = x.movedim(axis, -1)
    ml = torch.as_tensor(mat_l, dtype=x.dtype, device=x.device)
    mh = torch.as_tensor(mat_h, dtype=x.dtype, device=x.device)
    return (moved @ ml.T).movedim(-1, axis), (moved @ mh.T).movedim(-1, axis)


def _axis_up(lo: torch.Tensor, hi: torch.Tensor, axis: int, wavelet: str):
    """Inverse of :func:`_axis_down` along ``axis``."""
    pos = axis % lo.dim()
    if wavelet in HAAR:
        even = (lo + hi) * INV_SQRT2
        odd = (lo - hi) * INV_SQRT2
        shape = list(lo.shape)
        shape[pos] *= 2
        return torch.stack([even, odd], dim=pos + 1).reshape(shape)
    mat_l, mat_h = _banded_matrices(2 * lo.shape[axis], wavelet)
    ml = torch.as_tensor(mat_l, dtype=lo.dtype, device=lo.device)
    mh = torch.as_tensor(mat_h, dtype=lo.dtype, device=lo.device)
    out = lo.movedim(axis, -1) @ ml + hi.movedim(axis, -1) @ mh
    return out.movedim(-1, pos)


def dwt3(x: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """``(..., X, Y, Z, C)`` → ``(..., X/2, Y/2, Z/2, 8, C)`` (plain torch)."""
    parts = [x]
    for axis in (-4, -3, -2):
        parts = [b for p in parts for b in _axis_down(p, axis, wavelet)]
    return torch.stack(parts, dim=-2)


def idwt3(bands: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """Inverse of :func:`dwt3`: ``(..., X, Y, Z, 8, C)`` → ``(..., 2X, 2Y, 2Z, C)``."""
    parts = [bands[..., i, :] for i in range(8)]
    for axis in (-2, -3, -4):
        parts = [
            _axis_up(parts[i], parts[i + 1], axis, wavelet)
            for i in range(0, len(parts), 2)
        ]
    return parts[0]


def _kernel_eligible(x: torch.Tensor, shape, wavelet: str, channels: int) -> bool:
    """Single-channel fp32 Haar with even spatial sizes: the CUDA kernels'
    domain (the production image path)."""
    return (
        wavelet in HAAR
        and channels == 1
        and x.dtype == torch.float32
        and not any(int(s) % 2 for s in shape[-4:-1])
    )


def dwt3_flat(x: torch.Tensor, wavelet: str = "haar", impl: str = "auto") -> torch.Tensor:
    """3-D DWT with bands fused into channels: ``(..., X/2, Y/2, Z/2, 8*C)``,
    band-major. ``impl``: "auto" takes kernel K1 for single-channel fp32
    Haar, "pallas" forces it, "xla" takes the plain path."""
    if impl == "pallas" and wavelet not in HAAR:
        raise ValueError(f"the CUDA DWT kernel is Haar-only (got wavelet={wavelet!r})")
    if impl == "pallas" and x.shape[-1] != 1:
        raise ValueError(
            "the CUDA DWT kernel is single-channel only "
            f"(got C={x.shape[-1]}); use impl='auto' or 'xla'"
        )
    if impl == "pallas" or (
        impl == "auto" and _kernel_eligible(x, x.shape, wavelet, x.shape[-1])
    ):
        from fast_cwdm_tpu_torch.ops import wavelet_cuda

        return wavelet_cuda.HaarDWT3.apply(x[..., 0].contiguous())
    b = dwt3(x, wavelet)
    return b.reshape(*b.shape[:-2], b.shape[-2] * b.shape[-1])


def idwt3_flat(
    y: torch.Tensor, channels: int = 1, wavelet: str = "haar", impl: str = "auto"
) -> torch.Tensor:
    """Inverse of :func:`dwt3_flat`: ``(..., X, Y, Z, 8*C)`` → ``(..., 2X, 2Y, 2Z, C)``."""
    if impl == "pallas" and wavelet not in HAAR:
        raise ValueError(f"the CUDA IDWT kernel is Haar-only (got wavelet={wavelet!r})")
    if impl == "pallas" and channels != 1:
        raise ValueError(
            "the CUDA IDWT kernel is single-channel only "
            f"(got channels={channels}); use impl='auto' or 'xla'"
        )
    if channels == 1 and (
        impl == "pallas"
        or (
            impl == "auto"
            and _kernel_eligible(
                y, tuple(2 * s for s in y.shape[-4:-1]) + (1,), wavelet, 1
            )
        )
    ):
        from fast_cwdm_tpu_torch.ops import wavelet_cuda

        return wavelet_cuda.HaarIDWT3.apply(y.contiguous())[..., None]
    return idwt3(y.reshape(*y.shape[:-1], 8, channels), wavelet)


def scale_lll(flat_bands: torch.Tensor, factor: float, channels: int = 1) -> torch.Tensor:
    """Multiply the LLL band(s) of band-major flattened subbands by ``factor``."""
    n_bands = flat_bands.shape[-1] // channels
    scale = torch.ones(n_bands, channels, dtype=flat_bands.dtype, device=flat_bands.device)
    scale[0] = factor
    return flat_bands * scale.reshape(-1)


def dwt_normalized(x: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """DWT with LLL/3 (the network-input convention)."""
    return scale_lll(dwt3_flat(x, wavelet), 1.0 / LLL_SCALE, x.shape[-1])


def idwt_normalized(y: torch.Tensor, channels: int = 1, wavelet: str = "haar") -> torch.Tensor:
    """IDWT of network-convention bands (3*LLL)."""
    return idwt3_flat(scale_lll(y, LLL_SCALE, channels), channels, wavelet)


@functools.lru_cache(maxsize=None)
def _haar_mixing_matrix() -> np.ndarray:
    """M[band, corner]: bands = M @ block for an orthonormal 2×2×2 Haar
    block; corner index = 4·odd(X) + 2·odd(Y) + odd(Z)."""
    m = np.zeros((8, 8), dtype=np.float64)
    for band in range(8):
        for corner in range(8):
            sign = -1.0 if bin(band & corner).count("1") % 2 else 1.0
            m[band, corner] = sign / (2.0 * math.sqrt(2.0))
    return m


def haar_clamp_project(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Fused IDWT → clamp → DWT for Haar in the network LLL convention.

    ``x``: (..., 8) flat subbands (C=1). Equals
    ``dwt_normalized(clamp(idwt_normalized(x)))``: Haar is block-orthogonal,
    so the round trip is two 8×8 products around a clamp per latent voxel,
    with no spatial traffic. Computed in ``x``'s dtype (fp32 on the path).
    """
    m = torch.as_tensor(_haar_mixing_matrix(), dtype=x.dtype, device=x.device)
    s = torch.tensor([LLL_SCALE, 1, 1, 1, 1, 1, 1, 1], dtype=x.dtype, device=x.device)
    block = torch.clamp((x * s) @ m, lo, hi)
    return (block @ m.T) / s
