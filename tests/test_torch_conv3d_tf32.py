"""CPU checks of the fp32 fused conv's 3×TF32 kernel (``ops/csrc/conv3d_tf32.cu``
runs only on the card): the weight split and packing, a model of the
kernel's arithmetic (three TF32 products a term, the low parts read
truncated, the tensor cores' truncating sum drained every unit) against
the plain version and the JAX package's Pallas kernel,
a model of its shared-memory descriptor addressing driven by
``tf32_layout()``, the fp32 route, and the module's pack cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_cwdm_tpu.ops import conv3d_pallas as jc
from fast_cwdm_tpu_torch.models.unet import FusableConv3d
from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

torch.set_num_threads(2)

# ((X, Y, Z), Ci, Co) of every fused conv of the production UNet (fuse_conv)
PRODUCTION_CONVS = [
    ((112, 112, 80), 64, 64), ((112, 112, 80), 128, 64), ((112, 112, 80), 192, 64),
    ((56, 56, 40), 64, 128), ((56, 56, 40), 128, 128), ((56, 56, 40), 192, 128),
    ((56, 56, 40), 256, 128),
    ((28, 28, 20), 128, 128), ((28, 28, 20), 256, 128), ((28, 28, 20), 384, 128),
    ((14, 14, 10), 128, 256), ((14, 14, 10), 256, 256), ((14, 14, 10), 384, 256),
    ((14, 14, 10), 512, 256),
    ((7, 7, 5), 256, 256), ((7, 7, 5), 512, 256),
]


def _weight(ci, co, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal((3, 3, 3, ci, co))).astype(np.float32))


def _rna_numpy(a: np.ndarray) -> np.ndarray:
    """fp32 → TF32 (11 significant bits) to nearest, ties away from zero,
    by float64 arithmetic on the significand (independent of the bit
    trick in tc.tf32_round)."""
    m, e = np.frexp(np.abs(a.astype(np.float64)))  # m in [0.5, 1)
    q = np.floor(m * 2.0**11 + 0.5) / 2.0**11
    return (np.sign(a) * np.ldexp(q, e)).astype(np.float32)


def _trunc(t: torch.Tensor) -> torch.Tensor:
    """The tensor cores' reading of an fp32 operand: the low 13 bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _unpack(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Co/bn, Ci/8, 3, 2, 9, 2, bn, 4) → the (3, 3, 3, Ci, Co) hi and lo."""
    nb, nc, bn = p.shape[0], p.shape[1], p.shape[6]
    t = p.permute(3, 2, 4, 1, 5, 7, 0, 6)  # (hl, dx, t9, c, h, e, nb, n)
    t = t.reshape(2, 3, 3, 3, nc * 8, nb * bn)
    return t[0], t[1]


# (a) the weight split and its packing

@pytest.mark.parametrize("ci,co", [(8, 64), (16, 128), (24, 64)])
def test_pack_tf32_weights_unpacks_exactly(ci, co):
    """hi is w rounded to TF32 (low 13 bits zero, to nearest with ties away
    from zero, as cvt.rna), hi + lo == w exactly in fp32, and the packed
    tensor holds hi (then lo) of w[dx, dy, dz, 8c + 4h + e, 64·nb + n] at
    [nb, c, dx, ·, 3·dy + dz, h, n, e]."""
    w = _weight(ci, co, 1)
    p = tc.pack_tf32_weights(w)
    assert p.shape == (co // 64, ci // 8, 3, 2, 9, 2, 64, 4) and p.dtype == torch.float32
    assert p.is_contiguous()
    hi, lo = _unpack(p)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    np.testing.assert_array_equal(hi.numpy(), _rna_numpy(w.numpy()))
    assert torch.equal(hi + lo, w)
    assert float((lo.abs() - 2.0**-11 * w.abs()).max()) <= 0.0
    rng = np.random.default_rng(2)
    for _ in range(20):
        nb, c, dx, hl, t9, h, n, e = (int(rng.integers(s)) for s in p.shape)
        want = (hi, lo)[hl][dx, t9 // 3, t9 % 3, 8 * c + 4 * h + e, 64 * nb + n]
        assert p[nb, c, dx, hl, t9, h, n, e] == want


def test_tf32_round_ties_away_from_zero():
    a = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23, 3 * 2.0**-11,
                      0.0, -0.0, 2.0**-130], dtype=torch.float32)
    np.testing.assert_array_equal(tc.tf32_round(a).numpy(), _rna_numpy(a.numpy()))
    assert tc.tf32_round(a)[0] == 1 + 2.0**-10 and tc.tf32_round(a)[1] == -(1 + 2.0**-10)
    assert tc.tf32_round(a)[2] == 1.0


def test_pack_tf32_weights_refuses_other_grids():
    with pytest.raises(ValueError):  # Ci off the 8 grid
        tc.pack_tf32_weights(_weight(12, 64))
    with pytest.raises(ValueError):  # Co off the 64 grid
        tc.pack_tf32_weights(_weight(16, 96))
    with pytest.raises(ValueError):  # no 32-wide fp32 kernel
        tc.pack_tf32_weights(_weight(16, 64), 32)


# (b) the kernel's arithmetic

def _inputs(seed, bsz, ci, co, spatial, gn_kind):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, *spatial, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * (27 * ci) ** -0.5).astype(np.float32)
    b = (0.02 * rng.standard_normal(co)).astype(np.float32)
    lead = (bsz, ci) if gn_kind == "batch" else (ci,)
    gn = (0.1 * rng.standard_normal(lead), 0.5 + rng.random(lead),
          1.0 + 0.05 * rng.standard_normal(lead), 0.3 + 0.05 * rng.standard_normal(lead))
    return x, w, b, tuple(np.asarray(a, np.float32) for a in gn)


def _torch(x, w, b, gn):
    return (torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(w), torch.from_numpy(b),
            tuple(torch.from_numpy(a) for a in gn))


def _conv64(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv3d(a.double(), w.double().permute(4, 3, 0, 1, 2), padding=1)


def _toward_zero(s: torch.Tensor) -> torch.Tensor:
    """float64 → the fp32 value next to it toward zero (truncation), as
    float64."""
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f).double()


def _model(x, w, b, gn, products: int = 3, drain: int | None = 9) -> torch.Tensor:
    """The kernel's arithmetic: the fp32 prologue, zero padding after it,
    and for every 8-channel chunk, dx-plane and tap, in the kernel's order,
    the wgmma of hi·hi, then hi·lo and lo·hi (``products`` 3; lo read
    truncated to TF32; ``products`` 1: hi·hi alone), each one's 8 products
    summed and added into the tensor-core sum, which truncates to fp32.
    Every ``drain`` taps the tensor-core sum is added into an fp32 sum,
    rounded to nearest, and starts afresh (the kernel: 9, a unit); ``drain``
    None keeps one tensor-core sum over all of K. Then + b in fp32."""
    act = x if gn is None else tc.prologue_plain(x, gn)
    bsz, ci, X, Y, Z = act.shape
    co = w.shape[-1]
    pad = torch.zeros((bsz, X + 2, Y + 2, Z + 2, ci))
    pad[:, 1:-1, 1:-1, 1:-1] = act.permute(0, 2, 3, 4, 1)
    a_hi, w_hi = tc.tf32_round(pad), tc.tf32_round(w)
    terms = [(a_hi, w_hi), (a_hi, _trunc(w - w_hi)), (_trunc(pad - a_hi), w_hi)][:products]
    terms = [(a.double(), wt.double()) for a, wt in terms]
    n = bsz * X * Y * Z
    acc = total = torch.zeros((n, co), dtype=torch.float64)
    for c in range(0, ci, tc.TF_BK):
        k = slice(c, c + tc.TF_BK)
        for tap in range(27):
            dx, dy, dz = tap // 9, tap // 3 % 3, tap % 3
            for a, wt in terms:
                a_tap = a[:, dx:dx + X, dy:dy + Y, dz:dz + Z, k].reshape(n, tc.TF_BK)
                acc = _toward_zero(acc + a_tap @ wt[dx, dy, dz, k])
            if drain and (tap % 9 + 1) % drain == 0:
                total, acc = (total + acc).float().double(), torch.zeros_like(acc)
    out = (total if drain else acc).float() + b
    return out.reshape(bsz, X, Y, Z, co).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("bsz,ci,co,spatial,gn_kind", [
    (1, 8, 64, (6, 6, 6), "channel"),
    (2, 16, 64, (5, 7, 9), "batch"),
    (1, 64, 64, (4, 5, 6), "channel"),
    (1, 128, 128, (3, 4, 5), "batch"),
])
def test_3xtf32_model_within_the_kernel_limit(bsz, ci, co, spatial, gn_kind):
    """Three TF32 products a term, lo read truncated, a fresh truncating
    tensor-core sum a unit of 9 taps: tol_ratio against
    conv3d_fused_plain within TF32_TOL_RATIO (the card holds the kernel to
    it)."""
    x, w, b, gn = _torch(*_inputs(0, bsz, ci, co, spatial, gn_kind))
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    assert tc.tol_ratio(_model(x, w, b, gn), ref, x, w, gn) <= tc.TF32_TOL_RATIO


def test_one_tf32_product_fails_the_tolerance():
    """1×TF32 (hi·hi alone, both rounded to nearest) on the same kind of
    inputs, Ci 8 → Co 64 at 6×6×6: tol_ratio > 1, where 3×TF32 is within
    TF32_TOL_RATIO; so a route that took it would fail the card's check."""
    x, w, b, gn = _torch(*_inputs(0, 1, 8, 64, (6, 6, 6), "channel"))
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    one = tc.tol_ratio(_model(x, w, b, gn, 1), ref, x, w, gn)
    three = tc.tol_ratio(_model(x, w, b, gn, 3), ref, x, w, gn)
    assert one > 1.0 and three <= tc.TF32_TOL_RATIO, (one, three)


@pytest.mark.parametrize("bsz,ci,co,spatial", [
    (1, 64, 64, (4, 5, 6)), (1, 128, 128, (3, 4, 5)), (1, 256, 64, (4, 4, 4)),
])
def test_one_tensor_core_sum_over_k_exceeds_the_kernel_limit(bsz, ci, co, spatial):
    """The first design, every wgmma of a term into one truncating
    tensor-core sum (1,296 at Ci 128), drifts one way with K: beyond
    TF32_TOL_RATIO from Ci 64 on (on the card it read 0.2-0.5 and put a
    10-step fp32 volume 8.6e-4 off), where the kernel's fresh sum a unit
    stays within it; so the limit tells the two designs apart."""
    x, w, b, gn = _torch(*_inputs(0, bsz, ci, co, spatial, "channel"))
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    whole = tc.tol_ratio(_model(x, w, b, gn, drain=None), ref, x, w, gn)
    unit = tc.tol_ratio(_model(x, w, b, gn), ref, x, w, gn)
    assert whole > tc.TF32_TOL_RATIO >= unit, (whole, unit)


@pytest.mark.parametrize("block_x", [None, 2])
def test_3xtf32_model_matches_pallas(block_x):
    """The same model against the JAX package's Pallas K4a/K4b in fp32
    (interpret mode), inputs made with numpy: tol_ratio within
    TF32_TOL_RATIO with the Pallas output as the reference."""
    xn, wn, bn_, gnn = _inputs(3, 2, 8, 64, (4, 6, 6), "batch")
    ref = jc.conv3d_fused(jnp.asarray(xn), jnp.asarray(wn), jnp.asarray(bn_),
                          gn=tuple(jnp.asarray(a) for a in gnn), block_x=block_x, interpret=True)
    ref = torch.from_numpy(np.array(ref)).permute(0, 4, 1, 2, 3)
    x, w, b, gn = _torch(xn, wn, bn_, gnn)
    assert tc.tol_ratio(_model(x, w, b, gn), ref, x, w, gn) <= tc.TF32_TOL_RATIO


# (c) the shared-memory addressing

def _core_matrices(flat: torch.Tensor, start: int, sbo: int, lbo: int,
                   rows: int = 64) -> torch.Tensor:
    """A ``rows`` × 8 K-major TF32 operand read as the kernel's descriptor
    reads it (no swizzle): core matrix (i, k) of 8 rows × 16 bytes at start
    + i·SBO + k·LBO, row r 16 bytes further; ``flat`` holds fp32 elements
    (4 B), 4 to a row."""
    i = torch.arange(rows // 8).view(rows // 8, 1, 1, 1)
    r = torch.arange(8).view(1, 8, 1, 1)
    k = torch.arange(2).view(1, 1, 2, 1)
    e = torch.arange(4).view(1, 1, 1, 4)
    idx = (start + i * sbo + k * lbo + r * 16) // 4 + e  # (i, r, k, e)
    return flat[idx].reshape(rows, 8)


@pytest.mark.parametrize("bsz,ci,co,spatial,with_gn", [
    # ragged in X, Y and Z, two chunks
    pytest.param(1, 16, 64, (9, 11, 10), True, id="1-16-64-ragged-True"),
    # one block, two output blocks
    pytest.param(2, 8, 128, (8, 8, 8), False, id="2-8-128-one-block-False"),
])
def test_descriptor_addressing_model_matches_plain(bsz, ci, co, spatial, with_gn):
    """Stage each 8-channel chunk's halo as [hi, lo][k/4][voxel][4], read
    every tap's A tiles and each dx-plane slot's B tiles of
    pack_tf32_weights through the descriptors of ``tf32_layout()``, sum
    hi·hi + hi·lo + lo·hi + lo·lo (the kernel's three products and the one
    it drops) over taps and chunks, and get ``conv3d_fused_plain``: the
    kernel's addressing, in float64."""
    lay = tc.tf32_layout()
    (tx, ty, tz), (hx, hy, hz) = lay["tile"], lay["halo"]
    x, w, b, gn = _torch(*_inputs(4, bsz, ci, co, spatial, "channel"))
    gn = gn if with_gn else None
    act = x if gn is None else tc.prologue_plain(x, gn)
    X, Y, Z = spatial
    nx, ny, nz = -(-X // tx), -(-Y // ty), -(-Z // tz)
    # zero padding after the prologue, as the producer stages the halo
    padded = torch.zeros((bsz, nx * tx + 2, ny * ty + 2, nz * tz + 2, ci))
    padded[:, 1:X + 1, 1:Y + 1, 1:Z + 1] = act.permute(0, 2, 3, 4, 1)
    packed = tc.pack_tf32_weights(w)
    out = torch.zeros((bsz, nx * tx, ny * ty, nz * tz, co), dtype=torch.float64)
    for bi in range(bsz):
        for x0 in range(0, nx * tx, tx):
            for y0 in range(0, ny * ty, ty):
                for z0 in range(0, nz * tz, tz):
                    for nb in range(co // tc.TF_BN):
                        acc = torch.zeros((tx, 64, tc.TF_BN), dtype=torch.float64)
                        for c in range(ci // tc.TF_BK):
                            halo = padded[bi, x0:x0 + hx, y0:y0 + hy, z0:z0 + hz,
                                          c * 8:(c + 1) * 8]
                            hi = tc.tf32_round(halo)
                            parts = [p.reshape(-1, 2, 4).transpose(0, 1).reshape(-1)
                                     for p in (hi, halo - hi)]
                            stage = torch.cat(parts).double()
                            assert stage.numel() * 4 == 2 * lay["a_lo"]
                            for dx in range(3):
                                slot = packed[nb, c, dx].reshape(-1).double()
                                for t9 in range(9):
                                    tap = 9 * dx + t9
                                    bts = [_core_matrices(slot, lay["b_offset"](t9) + part,
                                                          lay["b_sbo"], lay["b_lbo"], tc.TF_BN)
                                           for part in (0, lay["b_lo"])]  # (n, k)
                                    for q in range(tx):
                                        a_s = [_core_matrices(stage, lay["a_offset"](q, tap) + part,
                                                              lay["a_sbo"], lay["a_lbo"])
                                               for part in (0, lay["a_lo"])]  # (m, k)
                                        acc[q] += sum(a @ bt.T for a in a_s for bt in bts)
                        # row m of plane q is voxel (x0 + q, y0 + m // 8, z0 + m % 8)
                        out[bi, x0:x0 + tx, y0:y0 + ty, z0:z0 + tz,
                            nb * tc.TF_BN:(nb + 1) * tc.TF_BN] = acc.reshape(tx, ty, tz, tc.TF_BN)
    out = out[:, :X, :Y, :Z] + b.double()
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn).permute(0, 2, 3, 4, 1).double()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


# (d) the fp32 route

@pytest.mark.parametrize("shape", PRODUCTION_CONVS, ids=lambda s: f"{s[0][0]}-{s[1]}to{s[2]}")
def test_route_fp32_production_shapes(shape):
    """fp32 at every level goes to the 3×TF32 wgmma kernel (its 4×8×8
    blocks: 64 at level 3, 8 at level 4, where the card measured it at half
    conv3d.cu's time), fp32 with Ci off the 8 grid or Co off the 64 grid to
    conv3d.cu's mma_sync path."""
    sp, ci, co = shape
    assert tc.route(torch.float32, 1, ci, co, *sp) == "wgmma_tf32"
    assert tc.route(torch.float32, 1, ci + 4, co, *sp) == "mma_sync"
    assert tc.route(torch.float32, 1, ci, co + 32, *sp) == "mma_sync"
    assert tc.PACK["wgmma_tf32"] == (torch.float32, tc.TF_BN)
    assert tc.pack_weights(_weight(8, co), *tc.PACK["wgmma_tf32"]).shape == (
        co // 64, 1, 3, 2, 9, 2, 64, 4)


def test_route_fp32_by_channels_alone():
    """The fp32 route is a function of Ci and Co: any grid on the 8/64
    grid takes the 3×TF32 kernel, one block (8³ at Co 64: 2) as a full
    level; a bf16 tensor of the same shape keeps its own route."""
    assert tc.route(torch.float32, 1, 64, 64, 8, 8, 8) == "wgmma_tf32"
    assert tc.route(torch.float32, 1, 8, 64, 1, 1, 1) == "wgmma_tf32"
    assert tc.route(torch.float32, 4, 64, 64, 8, 8, 8) == "wgmma_tf32"
    assert tc.route(torch.float32, 2, 256, 256, 14, 14, 10) == "wgmma_tf32"
    assert tc.route(torch.float32, 1, 24, 64, 112, 112, 80) == "wgmma_tf32"
    assert tc.route(torch.float32, 1, 12, 64, 112, 112, 80) == "mma_sync"
    assert tc.route(torch.float32, 1, 64, 32, 8, 8, 8) == "mma_sync"
    assert tc.route(torch.bfloat16, 1, 128, 128, 56, 56, 40) == "wgmma"
    assert tc.route(torch.bfloat16, 1, 24, 64, 112, 112, 80) == "mma_sync"


def test_packed_weight_cache_keeps_the_fp32_pack_apart():
    """The module keeps one pack per (dtype, width): the fp32 pack of
    width 64 beside the bf16 one, each what its packer gives, each kept and
    each rebuilt after a write."""
    conv = FusableConv3d(16, 64)
    dhwio = lambda: conv.weight.detach().permute(2, 3, 4, 1, 0)  # noqa: E731
    bf, f32 = conv.packed_weight(64), conv.packed_weight(64, torch.float32)
    assert bf.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(f32, tc.pack_tf32_weights(dhwio()))
    assert torch.equal(bf, tc.pack_wgmma_weights(dhwio()))
    assert conv.packed_weight(64, torch.float32) is f32 and conv.packed_weight() is bf
    with torch.no_grad():
        conv.weight.add_(1.0)
    f32b = conv.packed_weight(64, torch.float32)
    assert f32b is not f32 and torch.equal(f32b, tc.pack_tf32_weights(dhwio()))
    assert conv.packed_weight() is not bf
