"""Wrappers of the CUDA kernel behind K4a, K4b and K5: fused
[GroupNorm-apply + SiLU] → 3³ SAME conv → [+ bias + temb + skip].

Counterpart of ``fast_cwdm_tpu/ops/conv3d_pallas.py``. The three Pallas
kernels there (``_kernel``, ``_blocked_kernel``, ``_v4_make_kernel``)
compute one function and differ only in TPU layout devices; here one
hand-written kernel (``ops/csrc/conv3d.cu``) serves all three entry
points, and their TPU knobs (``fold_taps``, ``block_x``, ``tx``,
``pack_n``, ``unroll``, ``algo``, ``vmem_mb``, ``interpret``) are accepted
and ignored.

Tensors are logical NCDHW, as inside the UNet: ``x`` (B, Ci, X, Y, Z) and
the output (B, Co, X, Y, Z) in ``channels_last_3d`` memory, which is the
JAX package's (B, X, Y, Z, C). ``w`` keeps the JAX layout (3, 3, 3, Ci,
Co). ``gn`` is (mean, inv, scale, bias), each (Ci,) or (B, Ci).

A CPU tensor takes the plain torch version; a CUDA tensor launches the
kernel or raises. ``conv3d_fused.launches_k4a`` / ``launches_k4b`` (by
``block_x``) and ``conv3d_fused_v4.launches`` count kernel launches.
Inference only: the JAX package has no backward for these kernels either.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fast_cwdm_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CL = torch.channels_last_3d


def group_stats(x: torch.Tensor, num_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) GroupNorm mean and inverse std of ``x`` (B, C,
    *spatial), fp32 (B, C). The JAX package's reduction: one mean over the
    voxels and the group's channels of x and of x², var = max(E[x²] −
    E[x]², 0), rsqrt(var + 1e-5) (not ``GroupNorm32``'s mean of channel
    means)."""
    b, c = x.shape[:2]
    g = num_groups
    xf = x.float().movedim(1, -1).reshape(b, -1, g, c // g)
    mean = xf.mean(dim=(1, 3))
    mean_sq = (xf * xf).mean(dim=(1, 3))
    inv = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + 1e-5)
    return mean.repeat_interleave(c // g, dim=1), inv.repeat_interleave(c // g, dim=1)


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Ci,Co) DHWIO kernel → (9·Ci, 3·Co) with the X taps stacked on
    N and the (dy, dz, ci) im2col order on K (the TPU's N-packed layout,
    kept for signature parity; the CUDA kernel reads DHWIO)."""
    co = w.shape[-1]
    return w.permute(1, 2, 3, 0, 4).reshape(9 * w.shape[3], 3 * co)


def _per_batch(v: torch.Tensor, bsz: int, width: int) -> torch.Tensor:
    """(width,) or (B, width) → fp32 (B, width), contiguous."""
    v = torch.as_tensor(v).float()
    return v.expand(bsz, width).contiguous() if v.dim() == 1 else v.contiguous()


def prologue_plain(x: torch.Tensor, gn) -> torch.Tensor:
    """GN-apply + SiLU in fp32, rounded once to x's dtype."""
    bsz, c = x.shape[:2]
    bc = (bsz, c) + (1,) * (x.dim() - 2)
    mean, inv, scale, bias = (_per_batch(a, bsz, c).to(x.device).reshape(bc) for a in gn)
    xn = (x.float() - mean) * inv
    xn = xn * scale + bias
    return (xn * torch.sigmoid(xn)).to(x.dtype)


def _conv_plain(x, w, b, gn, temb, skip) -> torch.Tensor:
    act = x if gn is None else prologue_plain(x, gn)
    wt = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # (Co, Ci, 3, 3, 3)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # an fp32 reference on the card too
    try:
        out = F.conv3d(act.float(), wt, None, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    extra = b.float().to(x.device)[None]
    if temb is not None:
        extra = extra + _per_batch(temb, x.shape[0], w.shape[-1]).to(x.device)
    out = out + extra[(...,) + (None,) * 3]
    if skip is not None:
        out = out + skip.float()
    return out.to(x.dtype, memory_format=_CL)


def conv3d_fused_plain(x, w, b, *, gn=None, fold_taps=True, block_x=None,
                       interpret=False) -> torch.Tensor:
    """Plain torch version of K4a/K4b: prologue in fp32 rounded to x's
    dtype, zero padding after it, conv in fp32 of dtype-rounded weights
    (TF32 off), + b in fp32, one rounding."""
    return _conv_plain(x, w, b, gn, None, None)


def conv3d_fused_v4_plain(x, w, b, *, gn=None, temb=None, skip=None, tx=None,
                          pack_n=True, unroll=False, algo="im2col",
                          interpret=False, vmem_mb=100) -> torch.Tensor:
    """Plain torch version of K5: K4's prologue and conv, then
    + (b + temb) + skip in fp32 and one rounding."""
    return _conv_plain(x, w, b, gn, temb, skip)


def tol_ratio(ours: torch.Tensor, ref: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              gn=None) -> float:
    """max |ours − ref| over the kernel's tolerance: one ulp of ``ref`` in
    the output dtype (a flip of the final rounding) plus 2⁻¹⁶·conv(|act|,
    |w|) (fp32 sums in another order, and the tensor cores' accumulation,
    scale with the sum of the products' magnitudes). ≤ 1 passes."""
    act = (x if gn is None else prologue_plain(x, gn)).float().abs()
    mag = _conv_plain(act, w.abs().to(x.dtype).float(), torch.zeros(w.shape[-1]), None, None, None)
    mant = 7 if ours.dtype == torch.bfloat16 else 23
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - mant)
    return float(((ours.float() - ref).abs() / (ulp + 2.0**-16 * mag)).max())


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3d")
    p = ctypes.c_void_p
    lib.conv3d_fused.argtypes = [p] * 10 + [ctypes.c_int] * 7 + [p]
    lib.conv3d_fused.restype = ctypes.c_int
    return lib


def _launch(name, x, w, b, gn, temb, skip) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or not x.is_contiguous(memory_format=_CL):
        raise ValueError(
            f"{name}: x must be (B, C, X, Y, Z) in channels_last_3d memory, got "
            f"shape {tuple(x.shape)} strides {x.stride()}"
        )
    bsz, ci, X, Y, Z = x.shape
    if w.shape[:4] != (3, 3, 3, ci):
        raise ValueError(f"{name}: w must be (3, 3, 3, {ci}, Co), got {tuple(w.shape)}")
    co = w.shape[-1]
    if ci % 8 or co % 8:
        raise ValueError(f"{name}: the CUDA kernel needs Ci and Co multiples of 8, got {ci}, {co}")
    dev = x.device
    w = w.to(dev, x.dtype).contiguous()
    b = b.to(dev, torch.float32).contiguous()
    if b.shape != (co,):
        raise ValueError(f"{name}: b must be ({co},), got {tuple(b.shape)}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    params = [None] * 4
    if gn is not None:
        params = [_per_batch(a, bsz, ci).to(dev) for a in gn]
        if any(a.shape != (bsz, ci) for a in params):
            raise ValueError(f"{name}: gn entries must be ({ci},) or ({bsz}, {ci})")
    if temb is not None:
        temb = _per_batch(temb, bsz, co).to(dev)
        if temb.shape != (bsz, co):
            raise ValueError(f"{name}: temb must be ({co},) or ({bsz}, {co})")
    if skip is not None and (
        skip.shape != (bsz, co, X, Y, Z) or skip.dtype != x.dtype or skip.device != dev
        or not skip.is_contiguous(memory_format=_CL)
    ):
        raise ValueError(
            f"{name}: skip must be {x.dtype} ({bsz}, {co}, {X}, {Y}, {Z}) channels_last_3d "
            f"on {dev}, got {skip.dtype} {tuple(skip.shape)} strides {skip.stride()}"
        )
    out = torch.empty((bsz, co, X, Y, Z), dtype=x.dtype, device=dev, memory_format=_CL)
    with torch.cuda.device(dev):
        status = _lib().conv3d_fused(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), *(ptr(a) for a in params),
            ptr(temb), ptr(skip), out.data_ptr(), bsz, X, Y, Z, ci, co,
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, name)
    return out


def conv3d_fused(x, w, b, *, gn=None, fold_taps=True, block_x=None,
                 interpret=False) -> torch.Tensor:
    """K4a (``block_x`` None) / K4b (``block_x`` set): fused [GN-apply +
    SiLU] + 3³ SAME conv + b. ``x`` (B, Ci, X, Y, Z); ``w`` (3,3,3,Ci,Co);
    ``b`` (Co,); ``gn`` None for a plain conv."""
    if x.device.type == "cpu":
        return conv3d_fused_plain(x, w, b, gn=gn)
    y = _launch("conv3d_fused", x, w, b, gn, None, None)
    if block_x:
        conv3d_fused.launches_k4b += 1
    else:
        conv3d_fused.launches_k4a += 1
    return y


conv3d_fused.launches_k4a = 0
conv3d_fused.launches_k4b = 0


def conv3d_fused_v4(x, w, b, *, gn=None, temb=None, skip=None, tx=None, pack_n=True,
                    unroll=False, algo="im2col", interpret=False,
                    vmem_mb=100) -> torch.Tensor:
    """K5: fused [GN-apply + SiLU] → 3³ SAME conv → + b + temb + skip.
    ``temb`` (Co,) or (B, Co); ``skip`` (B, Co, X, Y, Z) in x's dtype."""
    if x.device.type == "cpu":
        return conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    y = _launch("conv3d_fused_v4", x, w, b, gn, temb, skip)
    conv3d_fused_v4.launches += 1
    return y


conv3d_fused_v4.launches = 0
