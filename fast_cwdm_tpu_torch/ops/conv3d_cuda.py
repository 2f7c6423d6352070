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

Four hand-written kernels compute the function on the card:
``csrc/conv3d_wgmma.cu`` (bf16 on ``wgmma``, an 8×8×8-voxel by 64-channel
block, a two-stage staging ring; the large levels; and the same kernel
with 32-channel blocks, ``wgmma_n32``, for Co a multiple of 32 only or a
grid short of blocks at 64, as the tp axis's Co/2 convs),
``csrc/conv3d_splitk.cu`` (bf16, K split across CTAs by :func:`splitk_plan`
and reduced in a fixed order; the small deep levels), both reading the
weight repacked once by :func:`pack_wgmma_weights` at their width;
``csrc/conv3d_tf32.cu`` (fp32 on ``wgmma`` as three TF32 products a term,
``wgmma_tf32``, a 4×8×8-voxel by 64-channel block; every production
level), reading the weight split and repacked once by
:func:`pack_tf32_weights`; and ``csrc/conv3d.cu``
(``mma.sync`` bf16 or fp32 FMA, any Ci and Co multiple of 8). :func:`route`
picks one from the dtype and shape alone, by a rule fixed from the card's
per-shape timings.

A CPU tensor takes the plain torch version; a CUDA tensor launches the
routed kernel or raises. ``conv3d_fused.launches_k4a`` / ``launches_k4b``
(by ``block_x``) and ``conv3d_fused_v4.launches`` count launches by entry
point, ``kernel_launches`` by kernel. Inference only: the JAX package has
no backward for these kernels either, and on the card a call that autograd
would have to differentiate raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fast_cwdm_tpu_torch.ops import _build, elementwise_cuda
from fast_cwdm_tpu_torch.parallel.mesh import all_reduce_sum_sp, current_sp

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CL = torch.channels_last_3d


def group_stats(x: torch.Tensor, num_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) GroupNorm mean and inverse std of ``x`` (B, C,
    *spatial), fp32 (B, C). The JAX package's reduction: one mean over the
    voxels and the group's channels of x and of x², var = max(E[x²] −
    E[x]², 0), rsqrt(var + 1e-5) (not ``GroupNorm32``'s mean of channel
    means); on the card outside autograd, one launch of the statistics
    kernel (``elementwise_cuda.gn_stats``). Under an active sp axis
    (``parallel.mesh.current_sp``) ``x`` is this rank's slab: Σx, Σx² and
    the voxel count of the slab are summed over the sp group in one
    all-reduce, so every rank gets the volume's statistics."""
    if current_sp() is None:
        return elementwise_cuda.gn_stats(x, num_groups, elementwise_cuda.GN_GROUP)
    b, c = x.shape[:2]
    g = num_groups
    xf = x.float().movedim(1, -1).reshape(b, -1, g, c // g)
    count = torch.full((b, 1), float(xf.shape[1] * xf.shape[3]), device=x.device)
    sums = all_reduce_sum_sp(torch.cat([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3)),
                                        count], dim=1))
    mean, mean_sq = sums[:, :g] / sums[:, -1:], sums[:, g:2 * g] / sums[:, -1:]
    return elementwise_cuda.group_norm_inv(mean, mean_sq, c // g)


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


# The 3×TF32 kernel's own bound on tol_ratio, below the shared 1: its
# tensor cores sum with truncation, and a design that summed all of K in
# them read 0.2-0.5 on an H100 while its 10-step fp32 volume missed the
# image bar by 8.6×; the kernel, a fresh tensor-core sum every 9 taps,
# reads below 0.04 (PERF.md, Findings).
TF32_TOL_RATIO = 0.1


# The wgmma kernel's block (csrc/conv3d_wgmma.cu): TX × TY × TZ output
# voxels by BN output channels (WG_BN, or WG_BN32 on the wgmma_n32 route),
# BK input channels per staged chunk.
WG_TILE = (8, 8, 8)
WG_BN, WG_BN32, WG_BK = 64, 32, 16
# Fewest blocks (of 132 SMs) at which the wgmma kernel is taken. Measured
# on an H100 at every production conv shape (PERF.md, Findings, PR 4 and
# 5): it wins from 96 blocks up (28×28×20 and larger); at 32 and fewer
# (14×14×10, 7×7×5) the split-K kernel is 2.5-10.5× faster than it.
WG_MIN_BLOCKS = 64
# The fp32 kernel (csrc/conv3d_tf32.cu): a TF_TILE block of output voxels
# (half the wgmma kernel's in X: two accumulators a plane) by TF_BN output
# channels, TF_BK input channels (one k8 step) per chunk.
TF_TILE = (4, 8, 8)
TF_BN, TF_BK = 64, 8


def wgmma_blocks(B: int, Co: int, X: int, Y: int, Z: int, bn: int = WG_BN) -> int:
    """The wgmma kernels' grid at output-channel width ``bn``."""
    tx, ty, tz = WG_TILE
    return B * -(-X // tx) * -(-Y // ty) * -(-Z // tz) * (Co // bn)


def wgmma_layout(bn: int = WG_BN) -> dict:
    """The wgmma kernel's shared-memory addressing at output-channel width
    ``bn``, in bytes: the halo of one chunk is [BK/8][halo voxel][8
    channels] (16 B per voxel row); the A descriptor of x-plane ``q`` and
    tap (dx, dy, dz) starts at ``a_offset(q, tap)``, its 8-row core
    matrices (8 z-consecutive voxels) step by ``a_sbo`` along M (one
    y-line) and by ``a_lbo`` along K (the next 8 channels). B (the packed
    weight, [27][BK/8][bn][8]) starts at ``b_offset(tap)`` with ``b_sbo``
    along N and ``b_lbo`` along K."""
    tx, ty, tz = WG_TILE
    hx, hy, hz = tx + 2, ty + 2, tz + 2
    hv = hx * hy * hz
    return dict(
        tile=WG_TILE, halo=(hx, hy, hz), a_lbo=hv * 16, a_sbo=hz * 16,
        b_lbo=bn * 16, b_sbo=8 * 16,
        a_offset=lambda q, tap: (((q + tap // 9) * hy + (tap // 3) % 3) * hz + tap % 3) * 16,
        b_offset=lambda tap: tap * (WG_BK // 8) * bn * 16,
    )


def tf32_layout(bn: int = TF_BN) -> dict:
    """The fp32 kernel's shared-memory addressing, in bytes: one chunk's
    halo is [hi, lo][TF_BK/4][halo voxel][4 fp32] (16 B per voxel row, a
    core-matrix row of 4 channels; ``a_lo`` from hi to lo); the A
    descriptor of x-plane ``q`` and tap (dx, dy, dz) starts at ``a_offset(q,
    tap)``, its core matrices step by ``a_sbo`` along M (one y-line) and by
    ``a_lbo`` along K (the other 4 channels of the k8 step). B, one weight
    slot (chunk ``c``, dx-plane ``dx`` of ``pack_tf32_weights``: [hi,
    lo][9][2][bn][4]), starts at ``b_offset(tap % 9)`` (``b_lo`` from hi to
    lo) with ``b_sbo`` along N and ``b_lbo`` along K."""
    tx, ty, tz = TF_TILE
    hx, hy, hz = tx + 2, ty + 2, tz + 2
    hv = hx * hy * hz
    return dict(
        tile=TF_TILE, halo=(hx, hy, hz), a_lbo=hv * 16, a_sbo=hz * 16,
        a_lo=(TF_BK // 4) * hv * 16, b_lbo=bn * 16, b_sbo=8 * 16,
        b_lo=9 * (TF_BK // 4) * bn * 16,
        a_offset=lambda q, tap: (((q + tap // 9) * hy + (tap // 3) % 3) * hz + tap % 3) * 16,
        b_offset=lambda t9: t9 * (TF_BK // 4) * bn * 16,
    )


# The split-K kernel (csrc/conv3d_splitk.cu): M tiles of SK_BM consecutive
# voxels ((x, y, z) order; 256 where the whole volume fits one), 64 output
# channels, K units of 16 input channels × the 9 taps of one dx-plane.
SK_BM = (128, 256)
SK_UNIT_TAPS = 9
SK_WORKSPACE_MAX = 16 * 10**6  # fp32 partials kept inside the 50 MB L2
SK_SMEM_MAX = 232448  # dynamic shared memory of one block on the H100
_SK_STAGE_W = 3 * SK_UNIT_TAPS * WG_BK * WG_BN * 2  # one chunk's weight, bytes


def splitk_box(v0: int, v_end: int, Y: int, Z: int) -> tuple[int, ...]:
    """The halo box of the tile of voxels [v0, v_end): (xl, yl, zl, nx, hy,
    hz). Its rows lie on output x-planes [xl, xl + nx); the box starts at
    input voxel (xl − 1, yl − 1, zl − 1) and spans (nx + 2) × hy × hz, with
    whole y-lines where the tile spans x-planes and whole z-lines where it
    spans y-lines. As ``tile_box`` in the kernel."""
    v1 = v_end - 1
    x0, x1 = v0 // (Y * Z), v1 // (Y * Z)
    y0, y1 = v0 // Z % Y, v1 // Z % Y
    if x1 > x0:
        return x0, 0, 0, x1 - x0 + 1, Y + 2, Z + 2
    if y1 > y0:
        return x0, y0, 0, 1, y1 - y0 + 3, Z + 2
    return x0, y0, v0 % Z, 1, 3, v1 % Z - v0 % Z + 3


@functools.lru_cache(maxsize=None)
def splitk_plan(B: int, Ci: int, Co: int, X: int, Y: int, Z: int, n_sm: int) -> dict:
    """The split-K kernel's schedule of one conv, on a card of ``n_sm`` SMs.
    Cached, since :func:`route` and :func:`_launch` ask for it on every
    call: the dict is shared, and its callers only read it.

    - M tiles (``tiles``, the voxels [v0, v_end) of each, flat (x, y, z)
      indices): ``bm`` consecutive voxels, the last cut at the end of the
      volume, as ``tile`` t in the kernel; ``bm`` = 256 where the volume
      fits one tile, else 128; ``mpad`` = mtiles·bm rows;
    - K units: unit u is input channels 16·(u // 3) … +15 at the 9 taps of
      dx-plane u % 3; ``units`` = 3·Ci/16;
    - ``S`` splits, split s taking units [units·s // S, units·(s+1) // S)
      (``splits``): of the S that give at least one wave, (mtiles · Co/64
      · B) · S ≥ n_sm CTAs, within ``units`` and a workspace of at most
      SK_WORKSPACE_MAX, the one with the shortest schedule at one CTA per
      SM (waves × units of the longest split), the fewest on a tie;
    - ``grid``, ``ctas``, ``workspace_bytes`` (fp32 [S][B·mpad][Co]),
      ``hv_cap`` (halo voxels per stage, the largest tile box) and
      ``smem_bytes`` (two stages: halo [2][hv_cap][8] bf16 + one chunk's
      weight, and the barriers); ``fits``: whether that shared memory is
      available (the route sends nothing else to the kernel)."""
    M = X * Y * Z
    bm = SK_BM[1] if M <= SK_BM[1] else SK_BM[0]
    tiles = tuple((v0, min(v0 + bm, M)) for v0 in range(0, M, bm))
    mtiles = len(tiles)
    mpad = mtiles * bm
    units = 3 * (Ci // WG_BK)
    base = mtiles * (Co // WG_BN) * B
    ws_per_split = 4 * B * mpad * Co
    s_max = max(1, min(units, SK_WORKSPACE_MAX // ws_per_split))
    S = min(range(min(units, -(-n_sm // base), s_max), s_max + 1),
            key=lambda s: (-(-base * s // n_sm) * -(-units // s), s))
    hv = max((b[3] + 2) * b[4] * b[5] for b in (splitk_box(*t, Y, Z) for t in tiles))
    hv_cap = -(-hv // 8) * 8
    smem = 128 + 2 * (32 * hv_cap + _SK_STAGE_W)
    return dict(bm=bm, tiles=tiles, mtiles=mtiles, mpad=mpad, units=units,
                unit=(WG_BK, SK_UNIT_TAPS), S=S,
                splits=tuple((units * s // S, units * (s + 1) // S) for s in range(S)),
                grid=(mtiles * (Co // WG_BN), S, B), ctas=base * S,
                workspace_bytes=ws_per_split * S, hv_cap=hv_cap, smem_bytes=smem,
                fits=smem <= SK_SMEM_MAX)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(dtype, B: int, Ci: int, Co: int, X: int, Y: int, Z: int) -> str:
    """Which kernel a CUDA tensor of this dtype and shape goes to. fp32
    with Ci % 8 == 0 and Co % 64 == 0: ``"wgmma_tf32"``
    (``csrc/conv3d_tf32.cu``; on an H100 it took half the time of
    conv3d.cu's fp32 path or less at every production shape, down to level
    4's 8 blocks: PERF.md, Findings). bf16 with Ci % 16 == 0, in this
    order: with Co % 64 == 0, ``"wgmma"`` (``csrc/conv3d_wgmma.cu``) where
    its grid has at least ``WG_MIN_BLOCKS`` blocks, else ``"splitk"``
    (``csrc/conv3d_splitk.cu``) where its halo box fits the shared memory;
    then, with Co % 32 == 0, ``"wgmma_n32"`` (the wgmma kernel at 32-wide
    blocks) where its grid has at least ``WG_MIN_BLOCKS`` blocks.
    Everything else (Ci or Co off those grids, a bf16 grid too small for
    both wgmma widths) ``"mma_sync"`` (``csrc/conv3d.cu``). All are
    hand-written kernels; no shape goes to the plain version on the card."""
    if dtype == torch.float32:
        return "wgmma_tf32" if Ci % TF_BK == 0 and Co % TF_BN == 0 else "mma_sync"
    if dtype != torch.bfloat16 or Ci % WG_BK:
        return "mma_sync"
    if Co % WG_BN == 0:
        if wgmma_blocks(B, Co, X, Y, Z) >= WG_MIN_BLOCKS:
            return "wgmma"
        if splitk_plan(B, Ci, Co, X, Y, Z, 1)["fits"]:
            return "splitk"
    if Co % WG_BN32 == 0 and wgmma_blocks(B, Co, X, Y, Z, WG_BN32) >= WG_MIN_BLOCKS:
        return "wgmma_n32"
    return "mma_sync"


def pack_wgmma_weights(w: torch.Tensor, bn: int = WG_BN) -> torch.Tensor:
    """(3,3,3,Ci,Co) DHWIO → (Co/bn, Ci/16, 27, 2, bn, 8) bf16, contiguous:
    for each ``bn``-wide output block (64, or 32 for the wgmma_n32 route)
    and 16-channel chunk, the 27 taps' B operands K-major (8 input channels
    of one output channel per 16-byte row), one contiguous slice per chunk
    for the kernel's bulk copy."""
    ci, co = w.shape[3], w.shape[4]
    if bn not in (WG_BN, WG_BN32):
        raise ValueError(f"pack_wgmma_weights: bn must be {WG_BN} or {WG_BN32}, got {bn}")
    if ci % WG_BK or co % bn:
        raise ValueError(f"pack_wgmma_weights: needs Ci % {WG_BK} == 0 and Co % {bn} == 0, "
                         f"got {ci}, {co}")
    t = w.to(torch.bfloat16).reshape(27, ci // WG_BK, WG_BK // 8, 8, co // bn, bn)
    return t.permute(4, 1, 0, 2, 5, 3).contiguous()


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 → fp32 rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, the low 13 bits zero: ``cvt.rna.tf32.f32``, as the
    fp32 kernel splits its activations (finite values)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_tf32_weights(w: torch.Tensor, bn: int = TF_BN) -> torch.Tensor:
    """(3,3,3,Ci,Co) DHWIO → (Co/bn, Ci/8, 3, 2, 9, 2, bn, 4) fp32,
    contiguous: for each ``bn``-wide output block, 8-channel chunk and
    dx-plane, the 9 taps' B operands K-major (4 input channels of one output
    channel per 16-byte row), first hi = :func:`tf32_round` of the fp32
    weight, then lo = w − hi (exact in fp32); one contiguous slice a (chunk,
    dx-plane) for the kernel's bulk copy."""
    ci, co = w.shape[3], w.shape[4]
    if bn != TF_BN:
        raise ValueError(f"pack_tf32_weights: bn must be {TF_BN}, got {bn}")
    if ci % TF_BK or co % bn:
        raise ValueError(f"pack_tf32_weights: needs Ci % {TF_BK} == 0 and Co % {bn} == 0, "
                         f"got {ci}, {co}")
    w = w.float()
    hi = tf32_round(w)
    t = torch.stack([hi, w - hi]).reshape(2, 3, 9, ci // TF_BK, 2, 4, co // bn, bn)
    return t.permute(6, 3, 1, 0, 2, 4, 7, 5).contiguous()


kernel_launches = {"conv3d_wgmma": 0, "conv3d_wgmma_n32": 0, "conv3d_splitk": 0,
                   "conv3d_wgmma_tf32": 0, "conv3d_mma_sync": 0}


# kernel → (source in csrc/, its C entry point, its pointer arguments, its
# int arguments: B, X, Y, Z, Ci, Co, then conv3d.cu's dtype code or the
# split-K kernel's bm and S)
_ENTRY = {"wgmma": ("conv3d_wgmma", "conv3d_wgmma", 10, 6),
          "wgmma_n32": ("conv3d_wgmma", "conv3d_wgmma_n32", 10, 6),
          "splitk": ("conv3d_splitk", "conv3d_splitk", 11, 8),
          "wgmma_tf32": ("conv3d_tf32", "conv3d_wgmma_tf32", 10, 6),
          "mma_sync": ("conv3d", "conv3d_fused", 10, 7)}
# the kernels that read a packed weight → (its dtype, its width):
# pack_wgmma_weights(w, bn) in bf16, pack_tf32_weights(w, bn) in fp32
PACK = {"wgmma": (torch.bfloat16, WG_BN), "wgmma_n32": (torch.bfloat16, WG_BN32),
        "splitk": (torch.bfloat16, WG_BN), "wgmma_tf32": (torch.float32, TF_BN)}


def pack_weights(w: torch.Tensor, dtype: torch.dtype, bn: int) -> torch.Tensor:
    """``w`` packed as the kernels of ``PACK`` entry (``dtype``, ``bn``)
    read it."""
    return (pack_wgmma_weights if dtype == torch.bfloat16 else pack_tf32_weights)(w, bn)


def _packed_shape(kernel: str, ci: int, co: int) -> tuple:
    dtype, bn = PACK[kernel]
    if dtype == torch.bfloat16:
        return (co // bn, ci // WG_BK, 27, 2, bn, 8)
    return (co // bn, ci // TF_BK, 3, 2, 9, 2, bn, 4)


def _entry(kernel: str):
    source, symbol, n_ptr, n_int = _ENTRY[kernel]
    fn = getattr(_build.load(source), symbol)
    p = ctypes.c_void_p
    fn.argtypes = [p] * n_ptr + [ctypes.c_int] * n_int + [p]
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


def tf32_rna_mismatches() -> tuple[int, int]:
    """Finite floats where the fp32 kernel's TF32 rounding of an activation
    (``cvt.rna.tf32.f32``, low bits cleared) differs from
    :func:`tf32_round`, the weights' split, counted on the card: (normal,
    zero or subnormal). (0, 0) makes the two splits one function."""
    fn = _build.load("conv3d_tf32").tf32_rna_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(2, dtype=torch.int64, device="cuda")
    _build.check(fn(bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
                 "tf32_rna_mismatches")
    return int(bad[0]), int(bad[1])


def tf32_read_mode() -> dict:
    """How one TF32 ``wgmma`` reads an fp32 operand from shared memory, on
    the card: 64 values 1 + j·2⁻²³ (j = 128·m + 64: low 13 bits below,
    at and above half a TF32 ulp) go through a product with 1. Returns the
    count that came out as each model (``truncate``: the low 13 bits
    dropped; ``round``: :func:`tf32_round`; ``exact``: kept) and ``mode``,
    the one model that all 64 match, or None."""
    fn = _build.load("conv3d_tf32").tf32_read_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    j = torch.arange(64, dtype=torch.int64) * 128 + 64
    a = (1.0 + j.double() * 2.0**-23).float()
    got = torch.empty(64, dtype=torch.float32, device="cuda")
    ac = a.cuda()
    _build.check(fn(ac.data_ptr(), got.data_ptr(), torch.cuda.current_stream().cuda_stream),
                 "tf32_read_probe")
    got = got.cpu()
    models = {"truncate": (a.view(torch.int32) & -0x2000).view(torch.float32),
              "round": tf32_round(a), "exact": a}
    counts = {k: int((got == m).sum()) for k, m in models.items()}
    mode = [k for k, n in counts.items() if n == 64]
    return {**counts, "mode": mode[0] if len(mode) == 1 else None}


def _launch(name, x, w, b, gn, temb, skip, w_packed=None, kernel=None) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch the kernel
    that :func:`route` picks. ``w_packed`` is the weight packed as the
    kernel reads it (``PACK``: ``pack_wgmma_weights(w, bn)`` in bf16,
    ``pack_tf32_weights(w, bn)`` in fp32) or a function returning it, called
    with ``bn`` on the bf16 kernels and with ``(bn, torch.float32)`` on the
    fp32 one; used only on the kernels of ``PACK`` (packed here when None).
    ``kernel`` (a key of ``_ENTRY``) overrides the route, for measurements
    that compare the kernels on one shape. One call counts once in ``kernel_launches``,
    whatever the number of CUDA launches (the split-K kernel's reduction
    is a second one)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, temb, skip, *(gn or ()))):
        # the freshly allocated output has no grad_fn: gradients would be
        # dropped without an error
        raise RuntimeError(
            f"{name}: the fused conv kernels have no backward (inference only, as "
            "fuse_conv in the JAX package); call it under torch.no_grad() or "
            "torch.inference_mode(), or on CPU tensors"
        )
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
    if kernel not in _ENTRY:
        raise ValueError(f"{name}: kernel must be one of {tuple(_ENTRY)}, got {kernel!r}")
    pdt, bn = PACK.get(kernel, (None, None))
    bk = WG_BK if pdt == torch.bfloat16 else TF_BK
    if bn and (x.dtype != pdt or ci % bk or co % bn):
        raise ValueError(f"{name}: the {kernel} kernel takes {pdt} with Ci % {bk} == 0 and "
                         f"Co % {bn} == 0, got {x.dtype}, {ci}, {co}")
    dev = x.device
    plan = None
    if kernel == "splitk":
        plan = splitk_plan(bsz, ci, co, X, Y, Z, _n_sm(dev.index or 0))
        if not plan["fits"]:
            raise ValueError(f"{name}: the split-K kernel's halo needs {plan['smem_bytes']} B "
                             f"of shared memory at {(X, Y, Z)}, more than {SK_SMEM_MAX}")
    if bn:
        if w_packed is None:
            w = pack_weights(w.to(dev), pdt, bn)
        elif callable(w_packed):
            w = w_packed(bn) if pdt == torch.bfloat16 else w_packed(bn, pdt)
        else:
            w = w_packed
        if w.shape != _packed_shape(kernel, ci, co) or w.dtype != pdt \
                or w.device != dev or not w.is_contiguous():
            packer = "pack_wgmma_weights" if pdt == torch.bfloat16 else "pack_tf32_weights"
            raise ValueError(f"{name}: w_packed must be {packer}(w, {bn}) on {dev}, "
                             f"got {w.dtype} {tuple(w.shape)}")
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
    ints, extra = (bsz, X, Y, Z, ci, co), []
    if kernel == "mma_sync":
        ints += (_DTYPE_CODE[x.dtype],)
    elif kernel == "splitk":
        ints += (plan["bm"], plan["S"])
        extra = [torch.empty(plan["workspace_bytes"] // 4, dtype=torch.float32, device=dev)]
    with torch.cuda.device(dev):
        status = _entry(kernel)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), *(ptr(a) for a in params),
            ptr(temb), ptr(skip), out.data_ptr(), *(t.data_ptr() for t in extra), *ints,
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
    (the route's pack kept by the caller, or a getter, as :func:`_launch`
    takes it) spares the wgmma, wgmma_n32, splitk and wgmma_tf32 routes a
    repack per call; the mma_sync route never reads it."""
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
