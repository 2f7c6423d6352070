"""CPU checks of the wgmma conv kernel's host side (``ops/csrc/conv3d_wgmma.cu``
runs only on the card): the weight repacking at both output-channel widths
(64, and 32 for the ``wgmma_n32`` route) and its cache on the module, a
model of the kernel's shared-memory descriptor addressing driven by the
wrapper's own tile constants, and the routing rule between the conv
kernels."""

import numpy as np
import pytest
import torch

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
# ((X, Y, Z), Ci, Co) → route of every fused conv a rank computes at tp 2
# (Co/2) and at sp 2 (a rank's Y slab with its halo plane), as phases
# tensor and spatial of chip_smoke.py reach them. At tp 2, level 0's Co 32
# is off the 64-wide grid and level 2's Co 64 has 48 blocks at 64 wide and
# a split-K box too large: both go to the 32-wide wgmma kernel.
TP_CONVS = {
    ((112, 112, 80), 64, 32): "wgmma_n32", ((112, 112, 80), 128, 32): "wgmma_n32",
    ((112, 112, 80), 192, 32): "wgmma_n32",
    ((56, 56, 40), 64, 64): "wgmma", ((56, 56, 40), 128, 64): "wgmma",
    ((56, 56, 40), 192, 64): "wgmma", ((56, 56, 40), 256, 64): "wgmma",
    ((28, 28, 20), 128, 64): "wgmma_n32", ((28, 28, 20), 256, 64): "wgmma_n32",
    ((28, 28, 20), 384, 64): "wgmma_n32",
    ((14, 14, 10), 128, 128): "splitk", ((14, 14, 10), 256, 128): "splitk",
    ((14, 14, 10), 384, 128): "splitk", ((14, 14, 10), 512, 128): "splitk",
    ((7, 7, 5), 256, 128): "splitk", ((7, 7, 5), 512, 128): "splitk",
}
SP_SLAB_CONVS = {
    ((112, 57, 80), 64, 64): "wgmma", ((112, 57, 80), 128, 64): "wgmma",
    ((112, 57, 80), 192, 64): "wgmma",
    ((56, 29, 40), 64, 128): "wgmma", ((56, 29, 40), 128, 128): "wgmma",
    ((56, 29, 40), 192, 128): "wgmma", ((56, 29, 40), 256, 128): "wgmma",
    ((28, 15, 20), 128, 128): "splitk", ((28, 15, 20), 256, 128): "splitk",
    ((28, 15, 20), 384, 128): "splitk",
    ((14, 8, 10), 128, 256): "splitk", ((14, 8, 10), 256, 256): "splitk",
    ((14, 8, 10), 384, 256): "splitk", ((14, 8, 10), 512, 256): "splitk",
    ((7, 7, 5), 256, 256): "splitk", ((7, 7, 5), 512, 256): "splitk",
}


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """(Co/bn, Ci/16, 27, 2, bn, 8) → the (3, 3, 3, Ci, Co) weight."""
    nb, nc, bn = packed.shape[0], packed.shape[1], packed.shape[4]
    return packed.permute(2, 1, 3, 5, 0, 4).reshape(3, 3, 3, nc * tc.WG_BK, nb * bn)


def _weight(ci, co, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((3, 3, 3, ci, co)).astype(np.float32))


@pytest.mark.parametrize("co,bn", [
    pytest.param(64, 64, id="64"), pytest.param(128, 64, id="128"),
    pytest.param(32, 32, id="32-bn32"), pytest.param(64, 32, id="64-bn32"),
])
@pytest.mark.parametrize("ci", [16, 64, 192])
def test_pack_wgmma_weights_unpacks_exactly(ci, co, bn):
    """The packed tensor holds w[tap, 16c + 8h + e, bn·nb + n] at [nb, c,
    tap, h, n, e], and unpacks to the bf16 DHWIO weight bit for bit, at
    both widths (64 the default)."""
    w = _weight(ci, co)
    p = tc.pack_wgmma_weights(w, bn) if bn != 64 else tc.pack_wgmma_weights(w)
    assert p.shape == (co // bn, ci // 16, 27, 2, bn, 8) and p.dtype == torch.bfloat16
    assert p.is_contiguous()
    assert torch.equal(_unpack(p), w.bfloat16())
    rng = np.random.default_rng(1)
    wb = w.bfloat16()
    for _ in range(20):
        nb, c, tap, h, n, e = (int(rng.integers(s)) for s in p.shape)
        assert p[nb, c, tap, h, n, e] == wb[tap // 9, tap // 3 % 3, tap % 3, 16 * c + 8 * h + e,
                                            bn * nb + n]


def test_pack_wgmma_weights_refuses_other_widths():
    with pytest.raises(ValueError):
        tc.pack_wgmma_weights(_weight(24, 64))
    with pytest.raises(ValueError):
        tc.pack_wgmma_weights(_weight(16, 72))
    with pytest.raises(ValueError):  # 32 is not a multiple of the default 64
        tc.pack_wgmma_weights(_weight(16, 32))
    with pytest.raises(ValueError):
        tc.pack_wgmma_weights(_weight(24, 32), 32)
    with pytest.raises(ValueError):
        tc.pack_wgmma_weights(_weight(16, 48), 32)
    with pytest.raises(ValueError):  # no kernel of that width
        tc.pack_wgmma_weights(_weight(16, 128), 128)


def test_packed_weight_is_cached_and_rebuilt_when_the_weight_changes():
    conv = FusableConv3d(16, 64)
    p1 = conv.packed_weight()
    assert conv.packed_weight() is p1  # kept, not rebuilt per call
    assert torch.equal(p1, tc.pack_wgmma_weights(conv.weight.detach().permute(2, 3, 4, 1, 0)))
    sd = {k: v + 1.0 for k, v in conv.state_dict().items()}
    conv.load_state_dict(sd)
    p2 = conv.packed_weight()
    assert p2 is not p1
    assert torch.equal(p2, tc.pack_wgmma_weights(sd["weight"].permute(2, 3, 4, 1, 0)))
    with torch.no_grad():
        conv.weight.mul_(2.0)  # an in-place write, as an optimizer step
    assert torch.equal(conv.packed_weight(),
                       tc.pack_wgmma_weights(conv.weight.detach().permute(2, 3, 4, 1, 0)))
    # keyed by the width: a 32-wide pack beside the 64-wide one, each kept,
    # each rebuilt after a write
    p64, p32 = conv.packed_weight(64), conv.packed_weight(32)
    assert p64 is conv.packed_weight() and p32 is conv.packed_weight(32)
    assert p32.shape == (2, 1, 27, 2, 32, 8) and p64.shape == (1, 1, 27, 2, 64, 8)
    assert torch.equal(p32, tc.pack_wgmma_weights(conv.weight.detach().permute(2, 3, 4, 1, 0), 32))
    with torch.no_grad():
        conv.weight.add_(1.0)
    assert conv.packed_weight(32) is not p32 and conv.packed_weight(64) is not p64
    assert torch.equal(conv.packed_weight(32),
                       tc.pack_wgmma_weights(conv.weight.detach().permute(2, 3, 4, 1, 0), 32))


def test_fused_conv_module_leaves_routing_to_the_conv(monkeypatch):
    """The module hands the conv its packed-weight getter and decides
    nothing itself: on the CPU (plain version) the getter is never called,
    and the forward equals conv3d_fused_plain."""
    import fast_cwdm_tpu_torch.models.unet as unet

    assert not hasattr(unet, "route")
    conv = FusableConv3d(16, 64)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 16, 5, 6, 7)).astype(np.float32))
    gn = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        0.1 * rng.standard_normal(16), 0.5 + rng.random(16), 1.0 + rng.random(16),
        0.1 * rng.standard_normal(16)))

    def no_repack():
        raise AssertionError("the CPU path packed the weight")

    monkeypatch.setattr(conv, "packed_weight", no_repack)
    with torch.no_grad():
        y = conv(x, gn)
        ref = tc.conv3d_fused_plain(x.contiguous(memory_format=torch.channels_last_3d),
                                    conv.weight.permute(2, 3, 4, 1, 0), conv.bias, gn=gn)
    assert torch.equal(y, ref)


def _core_matrices(flat: torch.Tensor, start: int, sbo: int, lbo: int,
                   rows: int = 64) -> torch.Tensor:
    """A ``rows`` × 16 K-major operand read as the kernel's descriptor reads
    it (no swizzle): core matrix (i, k) of 8 rows × 16 bytes at start +
    i·SBO + k·LBO, row r 16 bytes further; ``flat`` holds bf16 elements (2
    B)."""
    i = torch.arange(rows // 8).view(rows // 8, 1, 1, 1)
    r = torch.arange(8).view(1, 8, 1, 1)
    k = torch.arange(2).view(1, 1, 2, 1)
    e = torch.arange(8).view(1, 1, 1, 8)
    idx = (start + i * sbo + k * lbo + r * 16) // 2 + e  # (i, r, k, e)
    return flat[idx].reshape(rows, 16)


@pytest.mark.parametrize("bsz,ci,co,spatial,with_gn,bn", [
    # ragged in X, Y and Z, two chunks
    pytest.param(1, 32, 64, (9, 11, 10), True, 64, id="1-32-64-spatial0-True"),
    # one block, two output blocks
    pytest.param(2, 16, 128, (8, 8, 8), False, 64, id="2-16-128-spatial1-False"),
    # the 32-wide kernel: ragged in X, Y and Z, two chunks, one output block
    pytest.param(1, 32, 32, (9, 11, 10), True, 32, id="1-32-32-ragged-True-bn32"),
    # two 32-wide output blocks
    pytest.param(1, 16, 64, (8, 9, 8), False, 32, id="1-16-64-spatial-False-bn32"),
])
def test_descriptor_addressing_model_matches_plain(bsz, ci, co, spatial, with_gn, bn):
    """Stage each chunk's halo as [k/8][voxel][8], read every tap's A tile
    and B tile through the descriptors (start, LBO, SBO of
    ``wgmma_layout(bn)``), sum the 27 tap products over the chunks, and get
    ``conv3d_fused_plain``: the kernel's addressing, in float64, at both
    output-channel widths."""
    lay = tc.wgmma_layout(bn)
    assert lay["b_lbo"] == bn * 16
    (tx, ty, tz), (hx, hy, hz) = lay["tile"], lay["halo"]
    rng = np.random.default_rng(3)
    # bf16-representable inputs, so the model and the plain version agree
    x = torch.from_numpy(rng.standard_normal((bsz, *spatial, ci)).astype(np.float32))
    x = x.bfloat16().float().permute(0, 4, 1, 2, 3)
    w = (0.1 * _weight(ci, co, 4)).bfloat16().float()
    b = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    gn = None
    if with_gn:
        gn = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            0.1 * rng.standard_normal(ci), 0.5 + rng.random(ci),
            1.0 + 0.2 * rng.standard_normal(ci), 0.3 + 0.1 * rng.standard_normal(ci)))
    act = x if gn is None else tc.prologue_plain(x, gn)
    X, Y, Z = spatial
    nx, ny, nz = -(-X // tx), -(-Y // ty), -(-Z // tz)
    # zero padding after the prologue, as the producer stages the halo
    padded = torch.zeros((bsz, nx * tx + 2, ny * ty + 2, nz * tz + 2, ci), dtype=torch.float64)
    padded[:, 1:X + 1, 1:Y + 1, 1:Z + 1] = act.permute(0, 2, 3, 4, 1).double()
    packed = tc.pack_wgmma_weights(w, bn).double()
    out = torch.zeros((bsz, nx * tx, ny * ty, nz * tz, co), dtype=torch.float64)
    for bi in range(bsz):
        for x0 in range(0, nx * tx, tx):
            for y0 in range(0, ny * ty, ty):
                for z0 in range(0, nz * tz, tz):
                    for nb in range(co // bn):
                        acc = torch.zeros((tx, 64, bn), dtype=torch.float64)
                        for c in range(ci // tc.WG_BK):
                            halo = padded[bi, x0:x0 + hx, y0:y0 + hy, z0:z0 + hz,
                                          c * 16:(c + 1) * 16]
                            stage = halo.reshape(-1, 2, 8).transpose(0, 1).reshape(-1)
                            wflat = packed[nb, c].reshape(-1)
                            for tap in range(27):
                                bt = _core_matrices(wflat, lay["b_offset"](tap), lay["b_sbo"],
                                                    lay["b_lbo"], bn)  # (n, k)
                                for q in range(tx):
                                    a = _core_matrices(stage, lay["a_offset"](q, tap),
                                                       lay["a_sbo"], lay["a_lbo"])  # (m, k)
                                    acc[q] += a @ bt.T
                        # row m of plane q is voxel (x0 + q, y0 + m // 8, z0 + m % 8)
                        out[bi, x0:x0 + tx, y0:y0 + ty, z0:z0 + tz,
                            nb * bn:(nb + 1) * bn] = acc.reshape(tx, ty, tz, bn)
    out = out[:, :X, :Y, :Z] + b.double()
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn).permute(0, 2, 3, 4, 1).double()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", PRODUCTION_CONVS, ids=lambda s: f"{s[0][0]}-{s[1]}to{s[2]}")
def test_route_production_shapes(shape):
    """bf16 at levels 0-1 goes to the wgmma kernel and at levels 3-4 to the
    split-K kernel, never to the 32-wide one; fp32 to the 3×TF32 wgmma
    kernel, and bf16 with Ci or Co off the 16/32 grid to the mma.sync
    kernel; the route never names the plain version."""
    sp, ci, co = shape
    bf = tc.route(torch.bfloat16, 1, ci, co, *sp)
    assert bf in ("wgmma", "splitk")
    if sp[0] >= 56:
        assert bf == "wgmma"
    if sp[0] <= 14:
        assert bf == "splitk"
    assert tc.route(torch.float32, 1, ci, co, *sp) == "wgmma_tf32"
    assert tc.route(torch.bfloat16, 1, ci + 8, co, *sp) == "mma_sync"
    assert tc.route(torch.bfloat16, 1, ci, co + 8, *sp) == "mma_sync"
    # the rule between the bf16 kernels is a function of the number of
    # blocks the wgmma kernel gets
    blocks = np.prod([-(-n // t) for n, t in zip(sp, tc.WG_TILE)]) * (co // tc.WG_BN)
    assert (bf == "wgmma") == (blocks >= tc.WG_MIN_BLOCKS)


@pytest.mark.parametrize("shape,want", [
    *(pytest.param(k, v, id=f"tp-{'x'.join(map(str, k[0]))}-{k[1]}to{k[2]}")
      for k, v in TP_CONVS.items()),
    *(pytest.param(k, v, id=f"sp-{'x'.join(map(str, k[0]))}-{k[1]}to{k[2]}")
      for k, v in SP_SLAB_CONVS.items()),
])
def test_route_sharded_shapes(shape, want):
    """The tp axis's Co/2 convs leave the mma.sync kernel: level 0's Co 32
    and level 2's Co 64 go to the 32-wide wgmma kernel, the rest keep their
    route, as every sp slab does. Ci 8 off the 16 grid (Ci 24 at Ci
    16) and Co 8 off the 32 grid stay on mma.sync; a 32-wide route only
    where its grid has WG_MIN_BLOCKS blocks. In fp32 a shape takes the
    3×TF32 kernel where Co is on the 64 grid, else mma.sync."""
    sp, ci, co = shape
    got = tc.route(torch.bfloat16, 1, ci, co, *sp)
    assert got == want
    tf32 = co % tc.TF_BN == 0
    assert tc.route(torch.float32, 1, ci, co, *sp) == ("wgmma_tf32" if tf32 else "mma_sync")
    assert tc.route(torch.bfloat16, 1, ci + 8, co, *sp) == "mma_sync"
    assert tc.route(torch.bfloat16, 1, ci, co + 8, *sp) == "mma_sync"
    if got == "wgmma_n32":
        assert tc.wgmma_blocks(1, co, *sp, tc.WG_BN32) >= tc.WG_MIN_BLOCKS
        assert co % tc.WG_BN or tc.wgmma_blocks(1, co, *sp) < tc.WG_MIN_BLOCKS
        tc.pack_wgmma_weights(_weight(16, co), tc.PACK[got][1])  # packs at its width


def test_route_small_32_wide_grids_stay_on_mma_sync():
    """Co 32 with fewer than WG_MIN_BLOCKS 32-wide blocks, and Ci 24 or Co
    72 at a size the 32-wide kernel would fill, go to mma.sync."""
    assert tc.route(torch.bfloat16, 1, 64, 32, 16, 16, 16) == "mma_sync"  # 8 blocks
    assert tc.route(torch.bfloat16, 1, 64, 32, 32, 32, 32) == "wgmma_n32"  # 64 blocks
    assert tc.route(torch.bfloat16, 1, 24, 32, 112, 112, 80) == "mma_sync"
    assert tc.route(torch.bfloat16, 1, 24, 64, 28, 28, 20) == "mma_sync"
    assert tc.route(torch.bfloat16, 1, 128, 72, 28, 28, 20) == "mma_sync"
    assert tc.route(torch.float32, 1, 64, 32, 112, 112, 80) == "mma_sync"
