"""CPU checks of the split-K conv kernel's host side (``ops/csrc/conv3d_splitk.cu``
runs only on the card): its schedule (``conv3d_cuda.splitk_plan``) covers every
(voxel, output channel, input channel, tap) exactly once, fills the card and
keeps its workspace in L2, each tile's halo box holds every voxel its rows
read, and a float64 model of the kernel driven by the plan (staged boxes,
per-row tap addressing, per-split partials, the fixed-order reduction and the
epilogue) gives ``conv3d_fused_plain``."""

import numpy as np
import pytest
import torch

from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

torch.set_num_threads(2)

N_SM = 132  # the H100's SMs; the plan is handed the card's own count

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
# (B, (X, Y, Z), Ci, Co): the production shapes at B = 1, a ragged shape, B = 2
PLAN_CASES = ([(1,) + s for s in PRODUCTION_CONVS]
              + [(1, (5, 7, 9), 32, 64), (2, (14, 14, 10), 256, 256)])
DEEP = [c for c in PLAN_CASES if c[1] in ((14, 14, 10), (7, 7, 5))]


def _ids(c):
    return f"B{c[0]}-{'x'.join(map(str, c[1]))}-{c[2]}to{c[3]}"


@pytest.mark.parametrize("case", PLAN_CASES, ids=_ids)
def test_plan_covers_every_product_once(case):
    """Tiles partition the voxels, Co/64 blocks the output channels, the
    splits the K units, and each unit is one 16-channel chunk at the 9 taps
    of one dx-plane: every (voxel, co, ci, tap) product is computed by
    exactly one CTA of the grid."""
    bsz, (X, Y, Z), ci, co = case
    plan = tc.splitk_plan(bsz, ci, co, X, Y, Z, N_SM)
    M, bm = X * Y * Z, plan["bm"]
    assert plan["grid"] == (plan["mtiles"] * co // 64, plan["S"], bsz)
    assert plan["ctas"] == int(np.prod(plan["grid"]))
    voxels = np.zeros(M, dtype=np.int64)
    for v0, v_end in plan["tiles"]:
        assert 0 < v_end - v0 <= bm
        voxels[v0:v_end] += 1
    assert (voxels == 1).all() and plan["mpad"] == plan["mtiles"] * bm
    assert plan["mpad"] - M < bm
    assert all(v0 == t * bm for t, (v0, _) in enumerate(plan["tiles"]))  # tile t at row t·bm
    units = [u for u0, u1 in plan["splits"] for u in range(u0, u1)]
    assert units == list(range(plan["units"])) and plan["units"] == 3 * ci // 16
    assert all(u1 > u0 for u0, u1 in plan["splits"]) and len(plan["splits"]) == plan["S"]
    cover = np.zeros((ci // 16, 27), dtype=np.int64)
    for u in units:
        cover[u // 3, (u % 3) * 9:(u % 3 + 1) * 9] += 1
    assert (cover == 1).all() and plan["unit"] == (16, 9)


@pytest.mark.parametrize("case", DEEP, ids=_ids)
def test_plan_fills_the_card_within_l2_and_shared_memory(case):
    """At the deep shapes: at least one wave of CTAs, the fp32 partials
    within 16 MB, at most 1/8 of the rows padding, and two stages of halo
    and weight within the block's shared memory."""
    bsz, (X, Y, Z), ci, co = case
    plan = tc.splitk_plan(bsz, ci, co, X, Y, Z, N_SM)
    assert plan["ctas"] >= N_SM
    assert plan["workspace_bytes"] <= 16 * 10**6
    assert plan["workspace_bytes"] == 4 * plan["S"] * bsz * plan["mpad"] * co
    assert plan["mpad"] - X * Y * Z <= plan["mpad"] / 8
    assert plan["fits"] and plan["smem_bytes"] <= tc.SK_SMEM_MAX
    # fewer SMs never need more splits; a card of 8 SMs gets one wave too
    small = tc.splitk_plan(bsz, ci, co, X, Y, Z, 8)
    assert small["S"] <= plan["S"] and small["ctas"] >= 8


# the shapes the route gives the split-K kernel: the deep levels, the
# ragged and B = 2 shapes, and the kernel model's shapes below
BOX_CASES = PLAN_CASES[10:] + [(1, (1, 2, 130), 16, 64), (2, (3, 9, 19), 32, 64),
                               (1, (4, 4, 20), 48, 64)]


@pytest.mark.parametrize("case", BOX_CASES, ids=_ids)
def test_tile_boxes_hold_every_read(case):
    """Each tile's box holds every input voxel that its rows read at the 27
    taps, and is no larger than the plan's hv_cap; the kernel stages box
    planes [d0, d1 + nx − 1] for a dx range [d0, d1], which holds the reads
    of those taps."""
    bsz, (X, Y, Z), ci, co = case
    plan = tc.splitk_plan(bsz, ci, co, X, Y, Z, N_SM)
    assert plan["fits"]
    for v0, v_end in plan["tiles"]:
        xl, yl, zl, nx, hy, hz = tc.splitk_box(v0, v_end, Y, Z)
        assert (nx + 2) * hy * hz <= plan["hv_cap"]
        v = np.arange(v0, v_end)
        gx, gy, gz = v // (Y * Z), v // Z % Y, v % Z
        assert gx.min() == xl and gx.max() == xl + nx - 1
        for d in range(3):
            assert (gx - xl + d).min() >= d and (gx - xl + d).max() <= d + nx - 1
            assert (gy - yl + d).min() >= 0 and (gy - yl + d).max() < hy
            assert (gz - zl + d).min() >= 0 and (gz - zl + d).max() < hz


def _kernel_model(x, w, b, gn, temb, skip, plan):
    """The split-K kernel in float64, as the card runs it with ``plan``: for
    every CTA (tile, 64-channel block, split, batch) stage each chunk's box
    planes for the split's dx range into [2][hv_cap][8] (NaN elsewhere, so
    a read outside them shows), read every row's A operand at its box voxel
    plus the tap's offset and B from the packed weight, write the partial
    tile at its rows t·bm …; then sum every voxel's partials in split order
    and add b + temb + skip."""
    bsz, ci, X, Y, Z = x.shape
    co = w.shape[-1]
    M, bm, cap = X * Y * Z, plan["bm"], plan["hv_cap"]
    act = (x if gn is None else tc.prologue_plain(x, gn)).permute(0, 2, 3, 4, 1).double()
    padded = torch.zeros((bsz, X + 2, Y + 2, Z + 2, ci), dtype=torch.float64)
    padded[:, 1:-1, 1:-1, 1:-1] = act  # zero padding after the prologue
    packed = tc.pack_wgmma_weights(w).double()
    ws = torch.full((plan["S"], bsz, plan["mpad"], co), float("nan"), dtype=torch.float64)
    for s, (u0, u1) in enumerate(plan["splits"]):
        for bi in range(bsz):
            for t, (v0, v_end) in enumerate(plan["tiles"]):
                xl, yl, zl, nx, hy, hz = tc.splitk_box(v0, v_end, Y, Z)
                v = torch.arange(v0, v0 + bm)
                v[v >= v_end] = v0  # padding rows read row 0
                abase = ((v // (Y * Z) - xl) * hy + (v // Z % Y - yl)) * hz + (v % Z - zl)
                for nb in range(co // 64):
                    acc = torch.zeros((bm, 64), dtype=torch.float64)
                    c = u0 // 3
                    while 3 * c < u1:
                        d0, d1 = max(u0 - 3 * c, 0), min(u1 - 1 - 3 * c, 2)
                        stage = torch.full((2, cap, 8), float("nan"), dtype=torch.float64)
                        hv = torch.arange(d0 * hy * hz, (d1 + nx) * hy * hz)
                        hx_, hy_, hz_ = hv // (hy * hz), hv // hz % hy, hv % hz
                        vals = padded[bi, xl + hx_, yl + hy_, zl + hz_, 16 * c:16 * c + 16]
                        stage[:, hv] = vals.reshape(-1, 2, 8).transpose(0, 1)
                        wst = torch.full((27, 2, 64, 8), float("nan"), dtype=torch.float64)
                        wst[9 * d0:9 * d1 + 9] = packed[nb, c, 9 * d0:9 * d1 + 9]
                        for dx in range(d0, d1 + 1):
                            for t9 in range(9):
                                toff = (dx * hy + t9 // 3) * hz + t9 % 3
                                a = stage[:, abase + toff].transpose(0, 1).reshape(bm, 16)
                                bt = wst[9 * dx + t9].transpose(0, 1).reshape(64, 16)
                                acc += a @ bt.T
                        c += 1
                    ws[s, bi, t * bm:(t + 1) * bm, 64 * nb:64 * nb + 64] = acc
    # voxel v's partials at row v, as the reduction reads them
    out = ws[0][:, :M]
    for s in range(1, plan["S"]):
        out = out + ws[s][:, :M]
    extra = b.double()[None].expand(bsz, co)
    if temb is not None:
        extra = extra + temb.double()
    out = out + extra[:, None]
    if skip is not None:
        out = out + skip.permute(0, 2, 3, 4, 1).reshape(bsz, M, co).double()
    return out.reshape(bsz, X, Y, Z, co)


# (B, Ci, Co, spatial, gn, epilogue, n_sm): ragged tiles that span
# x-planes, one unit per split (partial dx ranges); B = 2 with per-(B, C)
# statistics, temb and skip; tiles on one z-line and on two y-lines of
# one plane; no prologue; ragged tiles across x-planes, B = 2, temb and
# skip
MODEL_CASES = [
    (1, 32, 64, (5, 7, 9), "channel", False, 16),
    (2, 16, 128, (7, 7, 5), "batch", True, 8),
    (1, 16, 64, (1, 2, 130), "channel", False, 30),
    (1, 48, 64, (4, 4, 20), None, False, 7),
    (2, 32, 64, (3, 9, 19), "batch", True, 40),
]


@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=lambda c: f"B{c[0]}-{c[1]}to{c[2]}-{'x'.join(map(str, c[3]))}")
def test_kernel_model_matches_plain(case):
    bsz, ci, co, spatial, gn_kind, epilogue, n_sm = case
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((bsz, *spatial, ci)).astype(np.float32))
    x = x.bfloat16().float().permute(0, 4, 1, 2, 3)  # bf16-representable inputs
    w = torch.from_numpy((0.1 * rng.standard_normal((3, 3, 3, ci, co))).astype(np.float32))
    w = w.bfloat16().float()
    b = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    gn = None
    if gn_kind:
        lead = (bsz, ci) if gn_kind == "batch" else (ci,)
        gn = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            0.1 * rng.standard_normal(lead), 0.5 + rng.random(lead),
            1.0 + 0.2 * rng.standard_normal(lead), 0.3 + 0.1 * rng.standard_normal(lead)))
    temb = skip = None
    if epilogue:
        temb = torch.from_numpy(rng.standard_normal((bsz, co)).astype(np.float32))
        skip = torch.from_numpy(rng.standard_normal((bsz, *spatial, co)).astype(np.float32))
        skip = skip.permute(0, 4, 1, 2, 3)
    plan = tc.splitk_plan(bsz, ci, co, *spatial, n_sm)
    assert plan["S"] > 1 and plan["fits"]  # the cases exercise the reduction
    out = _kernel_model(x, w, b, gn, temb, skip, plan)
    ref = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 4, 1).double(), atol=1e-5, rtol=1e-5)
    if not epilogue:
        torch.testing.assert_close(ref, tc.conv3d_fused_plain(x, w, b, gn=gn))


def test_route_sends_the_deep_levels_to_splitk_only_where_the_halo_fits():
    """bf16 shapes with too few wgmma blocks go to the split-K kernel where
    its halo box fits the shared memory, else to the 32-wide wgmma kernel
    where its grid is large enough, else to the mma.sync kernel."""
    assert tc.route(torch.bfloat16, 1, 256, 256, 7, 7, 5) == "splitk"
    assert tc.route(torch.bfloat16, 2, 32, 64, 5, 7, 9) == "splitk"
    plan = tc.splitk_plan(1, 16, 64, 1, 7, 400, 1)  # a tile over 2 y-lines of 400
    # 50 blocks at 64 wide, 100 at 32
    assert not plan["fits"] and tc.route(torch.bfloat16, 1, 16, 64, 1, 7, 400) == "wgmma_n32"
    plan = tc.splitk_plan(1, 16, 64, 1, 7, 240, 1)  # 30 blocks at 64 wide, 60 at 32
    assert not plan["fits"] and tc.route(torch.bfloat16, 1, 16, 64, 1, 7, 240) == "mma_sync"
    # a tile crossing an x-plane of 28×28×20 needs four whole planes of
    # halo, more than the shared memory; level 2 stays on wgmma
    plan = tc.splitk_plan(1, 128, 128, 28, 28, 20, N_SM)
    assert not plan["fits"] and plan["hv_cap"] == 4 * 30 * 22
    assert tc.route(torch.bfloat16, 1, 128, 128, 28, 28, 20) == "wgmma"
