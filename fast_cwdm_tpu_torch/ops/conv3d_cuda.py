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

Two hand-written kernels compute the function on the card:
``csrc/conv3d_wgmma.cu`` (bf16 on ``wgmma``, an 8×8×8-voxel by 64-channel
block, a two-stage staging ring; it reads the weight repacked once by
:func:`pack_wgmma_weights`) and ``csrc/conv3d.cu`` (``mma.sync`` bf16 or
fp32 FMA, any Ci and Co multiple of 8). :func:`route` picks one from the
dtype and shape alone, by a rule fixed from the card's per-shape timings.

A CPU tensor takes the plain torch version; a CUDA tensor launches the
routed kernel or raises. ``conv3d_fused.launches_k4a`` / ``launches_k4b``
(by ``block_x``) and ``conv3d_fused_v4.launches`` count launches by entry
point, ``kernel_launches`` by kernel. Inference only: the JAX package has
no backward for these kernels either.
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


# The wgmma kernel's block (csrc/conv3d_wgmma.cu): TX × TY × TZ output
# voxels by BN output channels, BK input channels per staged chunk.
WG_TILE = (8, 8, 8)
WG_BN, WG_BK = 64, 16
# Fewest blocks (of 132 SMs) at which the wgmma kernel is taken. Measured
# on an H100 at every production conv shape (PERF.md, Findings): faster at 96
# blocks and up (28×28×20 and larger, 1.7-2.1×), slower at 32 and fewer
# (14×14×10 and 7×7×5), where conv3d.cu's 128-voxel blocks fill more SMs.
WG_MIN_BLOCKS = 64


def wgmma_layout() -> dict:
    """The wgmma kernel's shared-memory addressing, in bytes: the halo of
    one chunk is [BK/8][halo voxel][8 channels] (16 B per voxel row); the
    A descriptor of x-plane ``q`` and tap (dx, dy, dz) starts at
    ``a_offset(q, tap)``, its 8-row core matrices (8 z-consecutive voxels)
    step by ``a_sbo`` along M (one y-line) and by ``a_lbo`` along K (the
    next 8 channels). B (the packed weight, [27][BK/8][BN][8]) starts at
    ``b_offset(tap)`` with ``b_sbo`` along N and ``b_lbo`` along K."""
    tx, ty, tz = WG_TILE
    hx, hy, hz = tx + 2, ty + 2, tz + 2
    hv = hx * hy * hz
    return dict(
        tile=WG_TILE, halo=(hx, hy, hz), a_lbo=hv * 16, a_sbo=hz * 16,
        b_lbo=WG_BN * 16, b_sbo=8 * 16,
        a_offset=lambda q, tap: (((q + tap // 9) * hy + (tap // 3) % 3) * hz + tap % 3) * 16,
        b_offset=lambda tap: tap * (WG_BK // 8) * WG_BN * 16,
    )


def route(dtype, B: int, Ci: int, Co: int, X: int, Y: int, Z: int) -> str:
    """Which kernel a CUDA tensor of this dtype and shape goes to:
    ``"wgmma"`` (``csrc/conv3d_wgmma.cu``) for bf16 with Ci % 16 == 0 and
    Co % 64 == 0 where its grid has at least ``WG_MIN_BLOCKS`` blocks, else
    ``"mma_sync"`` (``csrc/conv3d.cu``). Both are hand-written kernels; no
    shape goes to the plain version on the card."""
    tx, ty, tz = WG_TILE
    blocks = B * -(-X // tx) * -(-Y // ty) * -(-Z // tz) * (Co // WG_BN)
    if (dtype == torch.bfloat16 and Ci % WG_BK == 0 and Co % WG_BN == 0
            and blocks >= WG_MIN_BLOCKS):
        return "wgmma"
    return "mma_sync"


def pack_wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Ci,Co) DHWIO → (Co/64, Ci/16, 27, 2, 64, 8) bf16, contiguous:
    for each 64-wide output block and 16-channel chunk, the 27 taps' B
    operands K-major (8 input channels of one output channel per 16-byte
    row), one contiguous slice per chunk for the kernel's bulk copy."""
    ci, co = w.shape[3], w.shape[4]
    if ci % WG_BK or co % WG_BN:
        raise ValueError(f"pack_wgmma_weights: needs Ci % {WG_BK} == 0 and Co % {WG_BN} == 0, "
                         f"got {ci}, {co}")
    t = w.to(torch.bfloat16).reshape(27, ci // WG_BK, WG_BK // 8, 8, co // WG_BN, WG_BN)
    return t.permute(4, 1, 0, 2, 5, 3).contiguous()


kernel_launches = {"conv3d_wgmma": 0, "conv3d_mma_sync": 0}


# kernel → (source in csrc/, its C entry point, its int arguments: B, X, Y,
# Z, Ci, Co, and for conv3d.cu the dtype code)
_ENTRY = {"wgmma": ("conv3d_wgmma", "conv3d_wgmma", 6),
          "mma_sync": ("conv3d", "conv3d_fused", 7)}


def _entry(kernel: str):
    source, symbol, n_int = _ENTRY[kernel]
    fn = getattr(_build.load(source), symbol)
    p = ctypes.c_void_p
    fn.argtypes = [p] * 10 + [ctypes.c_int] * n_int + [p]
    fn.restype = ctypes.c_int
    return fn


def recip_mismatches() -> int:
    """Floats d in [1, 2^126) where the wgmma kernel's branch-free
    reciprocal differs from IEEE 1.0f / d, counted on the card (0 keeps
    its prologue bit for bit that of the plain version)."""
    fn = _build.load("conv3d_wgmma").recip_normal_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    _build.check(fn(bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
                 "recip_normal_mismatches")
    return int(bad.item())


def _launch(name, x, w, b, gn, temb, skip, w_packed=None, kernel=None) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch the kernel
    that :func:`route` picks. ``w_packed`` is ``pack_wgmma_weights(w)`` or a
    zero-argument function returning it, used only on the wgmma route
    (packed here when None). ``kernel`` ("wgmma" or "mma_sync") overrides
    the route, for measurements that compare the two kernels on one
    shape."""
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
    kernel = kernel or route(x.dtype, bsz, ci, co, X, Y, Z)
    if kernel not in ("wgmma", "mma_sync"):
        raise ValueError(f"{name}: kernel must be 'wgmma' or 'mma_sync', got {kernel!r}")
    if kernel == "wgmma" and (x.dtype != torch.bfloat16 or ci % WG_BK or co % WG_BN):
        raise ValueError(f"{name}: the wgmma kernel takes bfloat16 with Ci % {WG_BK} == 0 and "
                         f"Co % {WG_BN} == 0, got {x.dtype}, {ci}, {co}")
    dev = x.device
    if kernel == "wgmma":
        if w_packed is None:
            w = pack_wgmma_weights(w.to(dev))
        else:
            w = w_packed() if callable(w_packed) else w_packed
        if w.shape != (co // WG_BN, ci // WG_BK, 27, 2, WG_BN, 8) or w.dtype != torch.bfloat16 \
                or w.device != dev or not w.is_contiguous():
            raise ValueError(f"{name}: w_packed must be pack_wgmma_weights(w) on {dev}, got "
                             f"{w.dtype} {tuple(w.shape)}")
    else:
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
    ints = (bsz, X, Y, Z, ci, co) + (() if kernel == "wgmma" else (_DTYPE_CODE[x.dtype],))
    with torch.cuda.device(dev):
        status = _entry(kernel)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), *(ptr(a) for a in params),
            ptr(temb), ptr(skip), out.data_ptr(), *ints,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, f"{name} ({_ENTRY[kernel][0]}.cu)")
    kernel_launches[f"conv3d_{kernel}"] += 1
    return out


def conv3d_fused(x, w, b, *, gn=None, fold_taps=True, block_x=None,
                 interpret=False, w_packed=None) -> torch.Tensor:
    """K4a (``block_x`` None) / K4b (``block_x`` set): fused [GN-apply +
    SiLU] + 3³ SAME conv + b. ``x`` (B, Ci, X, Y, Z); ``w`` (3,3,3,Ci,Co);
    ``b`` (Co,); ``gn`` None for a plain conv. On the card, ``w_packed``
    (``pack_wgmma_weights(w)`` kept by the caller, or a zero-argument
    function returning it) spares the wgmma route a repack per call; the
    other routes never read it."""
    if x.device.type == "cpu":
        return conv3d_fused_plain(x, w, b, gn=gn)
    y = _launch("conv3d_fused", x, w, b, gn, None, None, w_packed)
    if block_x:
        conv3d_fused.launches_k4b += 1
    else:
        conv3d_fused.launches_k4a += 1
    return y


conv3d_fused.launches_k4a = 0
conv3d_fused.launches_k4b = 0


def conv3d_fused_v4(x, w, b, *, gn=None, temb=None, skip=None, tx=None, pack_n=True,
                    unroll=False, algo="im2col", interpret=False,
                    vmem_mb=100, w_packed=None) -> torch.Tensor:
    """K5: fused [GN-apply + SiLU] → 3³ SAME conv → + b + temb + skip.
    ``temb`` (Co,) or (B, Co); ``skip`` (B, Co, X, Y, Z) in x's dtype;
    ``w_packed`` as in :func:`conv3d_fused`."""
    if x.device.type == "cpu":
        return conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    y = _launch("conv3d_fused_v4", x, w, b, gn, temb, skip, w_packed)
    conv3d_fused_v4.launches += 1
    return y


conv3d_fused_v4.launches = 0
