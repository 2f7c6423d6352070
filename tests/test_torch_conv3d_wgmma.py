"""CPU checks of the wgmma conv kernel's host side (``ops/csrc/conv3d_wgmma.cu``
runs only on the card): the weight repacking and its cache on the module, a
model of the kernel's shared-memory descriptor addressing driven by the
wrapper's own tile constants, and the routing rule between the three conv
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


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """(Co/64, Ci/16, 27, 2, 64, 8) → the (3, 3, 3, Ci, Co) weight."""
    nb, nc = packed.shape[:2]
    return packed.permute(2, 1, 3, 5, 0, 4).reshape(3, 3, 3, nc * tc.WG_BK, nb * tc.WG_BN)


def _weight(ci, co, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((3, 3, 3, ci, co)).astype(np.float32))


@pytest.mark.parametrize("co", [64, 128])
@pytest.mark.parametrize("ci", [16, 64, 192])
def test_pack_wgmma_weights_unpacks_exactly(ci, co):
    """The packed tensor holds w[tap, 16c + 8h + e, 64nb + n] at [nb, c, tap,
    h, n, e], and unpacks to the bf16 DHWIO weight bit for bit."""
    w = _weight(ci, co)
    p = tc.pack_wgmma_weights(w)
    assert p.shape == (co // 64, ci // 16, 27, 2, 64, 8) and p.dtype == torch.bfloat16
    assert p.is_contiguous()
    assert torch.equal(_unpack(p), w.bfloat16())
    rng = np.random.default_rng(1)
    wb = w.bfloat16()
    for _ in range(20):
        nb, c, tap, h, n, e = (int(rng.integers(s)) for s in p.shape)
        assert p[nb, c, tap, h, n, e] == wb[tap // 9, tap // 3 % 3, tap % 3, 16 * c + 8 * h + e,
                                            64 * nb + n]


def test_pack_wgmma_weights_refuses_other_widths():
    with pytest.raises(ValueError):
        tc.pack_wgmma_weights(_weight(24, 64))
    with pytest.raises(ValueError):
        tc.pack_wgmma_weights(_weight(16, 72))


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


def _core_matrices(flat: torch.Tensor, start: int, sbo: int, lbo: int) -> torch.Tensor:
    """A 64 × 16 K-major operand read as the kernel's descriptor reads it
    (no swizzle): core matrix (i, k) of 8 rows × 16 bytes at start + i·SBO
    + k·LBO, row r 16 bytes further; ``flat`` holds bf16 elements (2 B)."""
    i = torch.arange(8).view(8, 1, 1, 1)
    r = torch.arange(8).view(1, 8, 1, 1)
    k = torch.arange(2).view(1, 1, 2, 1)
    e = torch.arange(8).view(1, 1, 1, 8)
    idx = (start + i * sbo + k * lbo + r * 16) // 2 + e  # (i, r, k, e)
    return flat[idx].reshape(64, 16)


@pytest.mark.parametrize("bsz,ci,co,spatial,with_gn", [
    (1, 32, 64, (9, 11, 10), True),    # ragged in X, Y and Z, two chunks
    (2, 16, 128, (8, 8, 8), False),    # one block, two output blocks
])
def test_descriptor_addressing_model_matches_plain(bsz, ci, co, spatial, with_gn):
    """Stage each chunk's halo as [k/8][voxel][8], read every tap's A tile
    and B tile through the descriptors (start, LBO, SBO of
    ``wgmma_layout``), sum the 27 tap products over the chunks, and get
    ``conv3d_fused_plain``: the kernel's addressing, in float64."""
    lay = tc.wgmma_layout()
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
    packed = tc.pack_wgmma_weights(w).double()
    out = torch.zeros((bsz, nx * tx, ny * ty, nz * tz, co), dtype=torch.float64)
    for bi in range(bsz):
        for x0 in range(0, nx * tx, tx):
            for y0 in range(0, ny * ty, ty):
                for z0 in range(0, nz * tz, tz):
                    for nb in range(co // tc.WG_BN):
                        acc = torch.zeros((tx, 64, tc.WG_BN), dtype=torch.float64)
                        for c in range(ci // tc.WG_BK):
                            halo = padded[bi, x0:x0 + hx, y0:y0 + hy, z0:z0 + hz,
                                          c * 16:(c + 1) * 16]
                            stage = halo.reshape(-1, 2, 8).transpose(0, 1).reshape(-1)
                            wflat = packed[nb, c].reshape(-1)
                            for tap in range(27):
                                bt = _core_matrices(wflat, lay["b_offset"](tap), lay["b_sbo"],
                                                    lay["b_lbo"])  # (n, k)
                                for q in range(tx):
                                    a = _core_matrices(stage, lay["a_offset"](q, tap),
                                                       lay["a_sbo"], lay["a_lbo"])  # (m, k)
                                    acc[q] += a @ bt.T
                        # row m of plane q is voxel (x0 + q, y0 + m // 8, z0 + m % 8)
                        out[bi, x0:x0 + tx, y0:y0 + ty, z0:z0 + tz,
                            nb * 64:(nb + 1) * 64] = acc.reshape(tx, ty, tz, tc.WG_BN)
    out = out[:, :X, :Y, :Z] + b.double()
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn).permute(0, 2, 3, 4, 1).double()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", PRODUCTION_CONVS, ids=lambda s: f"{s[0][0]}-{s[1]}to{s[2]}")
def test_route_production_shapes(shape):
    """bf16 at levels 0-1 goes to the wgmma kernel and at levels 3-4 to the
    split-K kernel; fp32 and Ci or Co off the 16/64 grid go to the mma.sync
    kernel; the route never names the plain version."""
    sp, ci, co = shape
    bf = tc.route(torch.bfloat16, 1, ci, co, *sp)
    assert bf in ("wgmma", "splitk")
    if sp[0] >= 56:
        assert bf == "wgmma"
    if sp[0] <= 14:
        assert bf == "splitk"
    assert tc.route(torch.float32, 1, ci, co, *sp) == "mma_sync"
    assert tc.route(torch.bfloat16, 1, ci + 8, co, *sp) == "mma_sync"
    assert tc.route(torch.bfloat16, 1, ci, co + 8, *sp) == "mma_sync"
    # the rule between the bf16 kernels is a function of the number of
    # blocks the wgmma kernel gets
    blocks = np.prod([-(-n // t) for n, t in zip(sp, tc.WG_TILE)]) * (co // tc.WG_BN)
    assert (bf == "wgmma") == (blocks >= tc.WG_MIN_BLOCKS)
