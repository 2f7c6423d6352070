"""3-D discrete wavelet transforms on channels-last tensors.

Port of ``fast_cwdm_tpu/ops/wavelet.py``: the 1-, 2- and 3-D transforms.
Layout is the JAX package's channels-last ``(..., X, Y, Z, C)``; 3-D
subband order is LLL, LLH, LHL, LHH, HLL, HLH, HHL, HHH, i.e. band index =
4*high(X) + 2*high(Y) + high(Z). Haar runs as paired sums and differences; Daubechies-N as banded
decimated matrices with zero-boundary truncation.

Under an active sp axis (``parallel.mesh.current_sp``) a tensor is one
rank's slab of the Y axis (``-3`` here): Haar reads and writes aligned
pairs, so it is local on a slab whose Y offset and length are even (the
forward transforms check it). A Daubechies filter of length L reads past
the slab: the forward transform takes L/2 − 1 planes from each neighbour
(``halo_pad``: zeros at the volume's edges, the truncation of the whole
volume's banded matrices), the inverse floor(L/4) coefficient rows, and
each applies the part of the banded matrix that falls on its slab.

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

from fast_cwdm_tpu_torch.parallel.mesh import current_sp, halo_pad

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


@functools.lru_cache(maxsize=None)
def _slab_matrices(n: int, wavelet: str) -> tuple[tuple, tuple, int, int]:
    """The banded matrices of one sp slab of ``n`` planes at an even
    offset: analysis ``(n//2, n + 2h)`` over the slab with ``h`` halo
    planes on each side (row k applies the filter from column 2k), and
    synthesis ``(n//2 + 2c, n)`` over its coefficients with ``c`` halo rows
    on each side (row k puts the filter at column 2(k − c) − (L/2 − 1)).
    Returns ``((L_fwd, H_fwd), (L_inv, H_inv), h, c)``."""
    lo, hi = filter_bank(wavelet)
    half = len(lo) // 2
    h, c = half - 1, half // 2
    fwd = tuple(np.zeros((n // 2, n + 2 * h)) for _ in range(2))
    inv = tuple(np.zeros((n // 2 + 2 * c, n)) for _ in range(2))
    for mats, f in zip(zip(fwd, inv), (lo, hi)):
        for k in range(n // 2):
            mats[0][k, 2 * k:2 * k + len(f)] = f
        for k in range(n // 2 + 2 * c):
            for j, w in enumerate(f):
                col = 2 * (k - c) + j - (half - 1)
                if 0 <= col < n:
                    mats[1][k, col] = w
    return fwd, inv, h, c


def _axis_down_sp(x: torch.Tensor, axis: int, wavelet: str):
    """:func:`_axis_down` of this rank's sp slab along ``axis`` (Y), its
    neighbours' planes read through the halo exchange."""
    (mat_l, mat_h), _, h, _ = _slab_matrices(x.shape[axis], wavelet)
    moved = halo_pad(x, axis % x.dim(), h).movedim(axis, -1)
    ml = torch.as_tensor(mat_l, dtype=x.dtype, device=x.device)
    mh = torch.as_tensor(mat_h, dtype=x.dtype, device=x.device)
    return (moved @ ml.T).movedim(-1, axis), (moved @ mh.T).movedim(-1, axis)


def _axis_up_sp(lo: torch.Tensor, hi: torch.Tensor, axis: int, wavelet: str):
    """:func:`_axis_up` of this rank's sp slab of coefficients along
    ``axis`` (Y), the neighbours' rows read through the halo exchange."""
    pos = axis % lo.dim()
    _, (mat_l, mat_h), _, c = _slab_matrices(2 * lo.shape[axis], wavelet)
    ml = torch.as_tensor(mat_l, dtype=lo.dtype, device=lo.device)
    mh = torch.as_tensor(mat_h, dtype=lo.dtype, device=lo.device)
    out = (halo_pad(lo, pos, c).movedim(axis, -1) @ ml
           + halo_pad(hi, pos, c).movedim(axis, -1) @ mh)
    return out.movedim(-1, pos)


@functools.lru_cache(maxsize=None)
def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: what a Python scalar becomes in JAX
    when it meets an array of that dtype (a bf16 array times 1/√2 is
    multiplied by bf16(1/√2); torch would use the float32 value)."""
    return float(torch.tensor(value, dtype=dtype))


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
        r = dtype_scalar(INV_SQRT2, x.dtype)
        return (even + odd) * r, (even - odd) * r
    mat_l, mat_h = _banded_matrices(x.shape[axis], wavelet)
    moved = x.movedim(axis, -1)
    ml = torch.as_tensor(mat_l, dtype=x.dtype, device=x.device)
    mh = torch.as_tensor(mat_h, dtype=x.dtype, device=x.device)
    return (moved @ ml.T).movedim(-1, axis), (moved @ mh.T).movedim(-1, axis)


def _axis_up(lo: torch.Tensor, hi: torch.Tensor, axis: int, wavelet: str):
    """Inverse of :func:`_axis_down` along ``axis``."""
    pos = axis % lo.dim()
    if wavelet in HAAR:
        r = dtype_scalar(INV_SQRT2, lo.dtype)
        even = (lo + hi) * r
        odd = (lo - hi) * r
        shape = list(lo.shape)
        shape[pos] *= 2
        return torch.stack([even, odd], dim=pos + 1).reshape(shape)
    mat_l, mat_h = _banded_matrices(2 * lo.shape[axis], wavelet)
    ml = torch.as_tensor(mat_l, dtype=lo.dtype, device=lo.device)
    mh = torch.as_tensor(mat_h, dtype=lo.dtype, device=lo.device)
    out = lo.movedim(axis, -1) @ ml + hi.movedim(axis, -1) @ mh
    return out.movedim(-1, pos)


def dwt1(x: torch.Tensor, wavelet: str = "haar") -> tuple[torch.Tensor, torch.Tensor]:
    """1-D DWT over the second-to-last axis of ``(..., L, C)`` → (lo, hi)."""
    return _axis_down(x, -2, wavelet)


def idwt1(lo: torch.Tensor, hi: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """Inverse of :func:`dwt1`."""
    return _axis_up(lo, hi, -2, wavelet)


def dwt2(x: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """2-D DWT of ``(..., H, W, C)`` → ``(..., H/2, W/2, 4, C)``, bands LL,
    LH, HL, HH (first letter: the first spatial axis)."""
    lo, hi = _axis_down(x, -3, wavelet)
    return torch.stack([b for part in (lo, hi) for b in _axis_down(part, -2, wavelet)], dim=-2)


def dwt2_tiny(x: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """The LL band of :func:`dwt2` alone."""
    lo, _ = _axis_down(x, -3, wavelet)
    return _axis_down(lo, -2, wavelet)[0]


def idwt2(bands: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """Inverse of :func:`dwt2`: ``(..., H, W, 4, C)`` → ``(..., 2H, 2W, C)``."""
    ll, lh, hl, hh = (bands[..., i, :] for i in range(4))
    return _axis_up(_axis_up(ll, lh, -2, wavelet), _axis_up(hl, hh, -2, wavelet), -3, wavelet)


def _sp_local(n_y: int | None = None) -> bool:
    """Whether an sp axis is active (the Y axis is a slab); under one, a
    forward transform's slab (``n_y`` its Y) must have an even offset and
    length, or ``ValueError``."""
    axis = current_sp()
    if axis is None:
        return False
    if n_y is not None and (n_y % 2 or axis.rank * n_y % 2):
        raise ValueError(
            f"a DWT under sp needs a Y slab with an even offset and length; slab {axis.rank} of "
            f"{axis.size} has length {n_y} at offset {axis.rank * n_y}")
    return True


def dwt3(x: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """``(..., X, Y, Z, C)`` → ``(..., X/2, Y/2, Z/2, 8, C)`` (plain torch)."""
    slab = _sp_local(x.shape[-3]) and wavelet not in HAAR
    parts = [x]
    for axis in (-4, -3, -2):
        down = _axis_down_sp if slab and axis == -3 else _axis_down
        parts = [b for p in parts for b in down(p, axis, wavelet)]
    return torch.stack(parts, dim=-2)


def idwt3(bands: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """Inverse of :func:`dwt3`: ``(..., X, Y, Z, 8, C)`` → ``(..., 2X, 2Y, 2Z, C)``."""
    slab = _sp_local() and wavelet not in HAAR
    parts = [bands[..., i, :] for i in range(8)]
    for axis in (-2, -3, -4):
        up = _axis_up_sp if slab and axis == -3 else _axis_up
        parts = [
            up(parts[i], parts[i + 1], axis, wavelet)
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
    _sp_local(x.shape[-3])
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
    _sp_local()
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


@functools.lru_cache(maxsize=None)
def _clamp_constants(device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixing matrix and the LLL scale vector of
    :func:`haar_clamp_project`, built once per (device, dtype) and kept
    there: a copy from host memory on every step would make the host wait
    on the device, and a capturing CUDA stream refuses it. Never written."""
    m = torch.as_tensor(_haar_mixing_matrix(), dtype=dtype, device=device)
    s = torch.tensor([LLL_SCALE, 1, 1, 1, 1, 1, 1, 1], dtype=dtype, device=device)
    return m, s


def haar_clamp_project(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Fused IDWT → clamp → DWT for Haar in the network LLL convention.

    ``x``: (..., 8) flat subbands (C=1). Equals
    ``dwt_normalized(clamp(idwt_normalized(x)))``: Haar is block-orthogonal,
    so the round trip is two 8×8 products around a clamp per latent voxel,
    with no spatial traffic. Computed in ``x``'s dtype (fp32 on the path).
    """
    m, s = _clamp_constants(x.device, x.dtype)
    block = torch.clamp((x * s) @ m, lo, hi)
    return (block @ m.T) / s
