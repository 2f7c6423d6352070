"""GroupNorm's statistics: ``conv3d_cuda.group_stats`` and
``nn.GroupNorm32`` against the code they ran before the statistics kernel
(bit for bit on the CPU), their routing (autograd, the sp axis and a
(B, C) input keep the torch path; no launch on the CPU), the kernel's
plan at the production UNet's 71 GroupNorm shapes, and, on the card, the
kernel (``ops/csrc/gn_stats.cu``) against its plain version at those
shapes, twice bit for bit and replayed from a CUDA graph, with its launches
in a production forward (71) and in a train step (0).

The card tests are marked ``cuda`` and skip without a GPU. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gn_stats.py
"""

import pytest
import torch

from fast_cwdm_tpu_torch import ops
from fast_cwdm_tpu_torch.models import nn as mnn
from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec

torch.set_num_threads(2)

# the GroupNorm inputs of one production UNet forward (cli/common.py's
# PRODUCTION_OVERRIDES at a 112×112×80 latent), (C, spatial) → sites,
# counted by spying on GroupNorm32 in a forward on meta tensors: 71 sites,
# 1.452e9 elements
PRODUCTION_GN_SHAPES = {
    (64, (112, 112, 80)): 9, (128, (112, 112, 80)): 3, (192, (112, 112, 80)): 1,
    (64, (56, 56, 40)): 2, (128, (56, 56, 40)): 9, (192, (56, 56, 40)): 1,
    (256, (56, 56, 40)): 2, (128, (28, 28, 20)): 10, (256, (28, 28, 20)): 3,
    (384, (28, 28, 20)): 1, (128, (14, 14, 10)): 2, (256, (14, 14, 10)): 9,
    (384, (14, 14, 10)): 1, (512, (14, 14, 10)): 2, (256, (7, 7, 5)): 13,
    (512, (7, 7, 5)): 3,
}
GROUPS = 32


def test_production_shapes_are_the_forwards_71_groupnorms():
    assert sum(PRODUCTION_GN_SHAPES.values()) == 71
    elements = sum(n * c * sp[0] * sp[1] * sp[2] for (c, sp), n in PRODUCTION_GN_SHAPES.items())
    assert round(elements / 1e9, 3) == 1.452


def _old_group_stats(x, num_groups):
    """``conv3d_cuda.group_stats`` before the statistics kernel (no sp axis)."""
    b, c = x.shape[:2]
    g = num_groups
    xf = x.float().movedim(1, -1).reshape(b, -1, g, c // g)
    mean = xf.mean(dim=(1, 3))
    mean_sq = (xf * xf).mean(dim=(1, 3))
    inv = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + 1e-5)
    return mean.repeat_interleave(c // g, dim=1), inv.repeat_interleave(c // g, dim=1)


def _old_groupnorm32(norm, x, act=None):
    """``GroupNorm32.forward`` before the statistics kernel (no sp axis)."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xf = x.float()
    spatial = tuple(range(2, x.dim()))
    mean_c = xf.mean(dim=spatial) if spatial else xf
    mean_sq_c = (xf * xf).mean(dim=spatial) if spatial else xf * xf
    mean = mean_c.reshape(b, g, c // g).mean(dim=-1)
    mean_sq = mean_sq_c.reshape(b, g, c // g).mean(dim=-1)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + 1e-5)
    mean_pc = mean.repeat_interleave(c // g, dim=-1)
    inv_pc = inv.repeat_interleave(c // g, dim=-1)
    if act == "silu":
        return ec.gn_apply_silu(x, mean_pc, inv_pc, norm.weight, norm.bias)
    bc = (b, c) + (1,) * (x.dim() - 2)
    scale = norm.weight.reshape((1, c) + (1,) * (x.dim() - 2))
    shift = norm.bias.reshape(scale.shape)
    y = (xf - mean_pc.reshape(bc)) * inv_pc.reshape(bc) * scale + shift
    return y.to(x.dtype)


def _input(c, dtype, channels_last, shape=(2, None, 6, 5, 4), seed=0, device="cpu"):
    """(B, C, X, Y, Z) with per-channel offsets and scales, in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, _, *sp = shape
    x = torch.randn((b, *sp, c), generator=g, device=device)
    x = x * torch.rand(c, generator=g, device=device) * 2 + torch.randn(
        c, generator=g, device=device)
    x = x.to(dtype).permute(0, 4, 1, 2, 3)  # channels_last_3d
    return x if channels_last else x.contiguous()


def _norm(c, seed=1):
    norm = mnn.GroupNorm32(GROUPS, c)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(c, generator=g) + 0.5)
        norm.bias.copy_(torch.randn(c, generator=g))
    return norm


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 192, 512])
def test_group_stats_is_unchanged_on_the_cpu(c, dtype, channels_last):
    x = _input(c, dtype, channels_last)
    mean, inv = tc.group_stats(x, GROUPS)
    old_mean, old_inv = _old_group_stats(x, GROUPS)
    assert torch.equal(mean, old_mean) and torch.equal(inv, old_inv)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 192, 512])
def test_groupnorm32_is_unchanged_on_the_cpu(c, dtype, channels_last, act):
    x = _input(c, dtype, channels_last)
    norm = _norm(c)
    with torch.no_grad():
        y, old = norm(x, act=act), _old_groupnorm32(norm, x, act)
    assert y.dtype == x.dtype and torch.equal(y, old)


@pytest.mark.parametrize("act", [None, "silu"])
def test_a_grad_enabled_groupnorm_keeps_its_gradient(act):
    """Under autograd the statistics stay differentiable torch: the same
    output and gradients as before, bit for bit, and no launch."""
    x = _input(64, torch.float32, True).requires_grad_(True)
    norm = _norm(64)
    before = ec.gn_stats.launches
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    y = norm(x, act=act)
    grads = torch.autograd.grad((y * g).sum(), (x, norm.weight, norm.bias))
    old = _old_groupnorm32(norm, x, act)
    old_grads = torch.autograd.grad((old * g).sum(), (x, norm.weight, norm.bias))
    assert torch.equal(y, old)
    for ours, ref in zip(grads, old_grads):
        assert torch.equal(ours, ref)
    assert ec.gn_stats.launches == before


class _FakeSp:
    """Stands in for an active sp axis of one rank."""


@pytest.mark.parametrize("site", ["group_stats", "groupnorm32"])
def test_an_active_sp_axis_keeps_the_all_reduce(monkeypatch, site):
    """Under an sp axis the statistics come from the all-reduce of the
    slab's sums: the statistics kernel's entry is never called."""
    reduced = []

    def all_reduce(t):
        reduced.append(t.shape)
        return t

    def refuse(*args):
        raise AssertionError("gn_stats called under an sp axis")

    module = tc if site == "group_stats" else mnn
    monkeypatch.setattr(module, "current_sp", lambda: _FakeSp())
    monkeypatch.setattr(module, "all_reduce_sum_sp", all_reduce)
    monkeypatch.setattr(ec, "gn_stats", refuse)
    x = _input(64, torch.float32, True)
    if site == "group_stats":
        mean, inv = tc.group_stats(x, GROUPS)
        ref = _old_group_stats(x, GROUPS)
    else:
        norm = _norm(64)
        with torch.no_grad():
            mean, inv = norm(x), None
            ref = (_old_groupnorm32(norm, x), None)
    assert len(reduced) == 1
    torch.testing.assert_close(mean, ref[0], rtol=1e-5, atol=1e-5)
    if inv is not None:
        torch.testing.assert_close(inv, ref[1], rtol=1e-5, atol=0)


def test_a_bc_input_keeps_the_torch_path():
    """The classifier's GroupNorm of a (B, C) input: its own channel means."""
    x = torch.randn((3, 2048), generator=torch.Generator().manual_seed(2))
    norm = _norm(2048)
    with torch.no_grad():
        assert torch.equal(norm(x), _old_groupnorm32(norm, x))


def test_the_launch_counter_stays_zero_on_the_cpu():
    from fast_cwdm_tpu_torch.models.unet import UNetModel

    model = UNetModel(image_size=8, in_channels=4, model_channels=16, out_channels=4,
                      num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
                      num_groups=8, dims=3, resblock_updown=True, fuse_gn_silu=True,
                      fuse_conv=True).eval()
    x = torch.randn((1, 8, 8, 8, 4), generator=torch.Generator().manual_seed(3))
    before = ops.launch_counts()
    with torch.no_grad():
        y = model(x.permute(0, 4, 1, 2, 3), torch.tensor([1]))
    assert torch.isfinite(y).all()
    assert "gn_stats" in before and ops.launches_since(before) == {}


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = _input(64, torch.bfloat16, True)
    strided = x.permute(0, 1, 3, 2, 4)  # neither contiguous nor channels last
    with pytest.raises(ValueError, match="channels-last"):
        ec.gn_stats_plan(strided)
    with pytest.raises(ValueError, match="channels-last"):
        ec._gn_stats_kernel(strided, GROUPS, ec.GN_GROUP)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ec._gn_stats_kernel(x.half(), GROUPS, ec.GN_GROUP)
    with pytest.raises(ValueError, match="multiple of num_groups"):
        ec._gn_stats_kernel(x, 24, ec.GN_GROUP)
    with pytest.raises(ValueError, match="formula"):
        ec.gn_stats_plain(x, GROUPS, 2)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", sorted(PRODUCTION_GN_SHAPES))
def test_the_plan_covers_every_production_shape(shape, dtype, channels_last):
    """At every production shape: 16-byte vectors, a block within 512
    threads, chunks that cover the voxels (none empty), level 0 on at least
    one CTA an SM and level 4 on a handful, a workspace of a few MB."""
    c, sp = shape
    x = torch.empty((1, *sp, c), dtype=dtype, device="meta").permute(0, 4, 1, 2, 3)
    x = x if channels_last else x.contiguous()
    layout, vec, bdx, bdy, chunks, chunk_len = ec.gn_stats_plan(x)
    s = sp[0] * sp[1] * sp[2]
    assert layout == int(channels_last)
    full = 16 // x.element_size()
    assert vec == (full if channels_last or s % full == 0 else 1)  # level 4: 245 voxels
    assert bdx * bdy <= ec.GN_THREADS and (bdy == 1) != channels_last
    n = s if channels_last else s // vec
    assert (chunks - 1) * chunk_len < n <= chunks * chunk_len
    if channels_last:
        cgroups = -(-(c // vec) // bdx)
        assert cgroups == 1 and bdx == c // vec  # a voxel's channels in one row of threads
        ctas = cgroups * chunks
    else:
        ctas = c * chunks
    if sp == (112, 112, 80):
        assert 132 <= ctas <= ec.GN_TARGET_CTAS + c
    if sp == (7, 7, 5) and channels_last:
        assert ctas <= 8
    assert 2 * (chunks + 1) * c * 4 < 2**22


def test_the_plan_takes_scalar_loads_off_the_vector_grid():
    x = torch.empty((2, 5, 3, 3, 12), dtype=torch.bfloat16, device="meta")
    assert ec.gn_stats_plan(x.permute(0, 4, 1, 2, 3))[:2] == (1, 1)  # C % 8
    assert ec.gn_stats_plan(x.permute(0, 4, 1, 2, 3).contiguous())[:2] == (0, 1)  # S % 8
    flat = torch.empty((1, 10, 64), dtype=torch.float32, device="meta").transpose(1, 2)
    assert ec.gn_stats_plan(flat)[:2] == (1, 4)  # the attention block's (B, C, T) view


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    """mean within 1e-5 of the group's scale (|mean| + std), inv within 1e-5
    relative: fp32 sums in another order than torch's reductions."""
    (mean, inv), (rmean, rinv) = got, ref
    scale = rmean.abs() + 1.0 / rinv
    return bool(((mean - rmean).abs() <= 1e-5 * scale).all()
                and ((inv - rinv).abs() <= 1e-5 * rinv).all())


@pytest.mark.cuda
@pytest.mark.parametrize("formula", [ec.GN_GROUP, ec.GN_CHANNEL_MEANS])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_matches_plain_at_the_production_shapes(cuda, dtype, channels_last, formula):
    """Every production shape, and off-grid and batch-2 shapes: the kernel
    within the tolerance of ``_close`` of the plain version on the same
    input, two launches bit for bit, one launch a call."""
    shapes = [(c, (1, None, *sp), GROUPS) for c, sp in sorted(PRODUCTION_GN_SHAPES)]
    # batch 2; channels off bf16's vector (scalar loads), voxels off it
    shapes += [(64, (2, None, 9, 10, 12), GROUPS), (12, (2, None, 3, 3, 3), 4),
               (24, (1, None, 5, 3, 7), 8)]
    bad = []
    for i, (c, shape, groups) in enumerate(shapes):
        x = _input(c, dtype, channels_last, shape=shape, seed=i, device=cuda)
        before = ec.gn_stats.launches
        got = ec.gn_stats(x, groups, formula)
        again = ec.gn_stats(x, groups, formula)
        torch.cuda.synchronize()
        assert ec.gn_stats.launches == before + 2
        ref = ec.gn_stats_plain(x, groups, formula)
        if not _close(got, ref):
            bad.append((c, shape, float((got[0] - ref[0]).abs().max()),
                        float(((got[1] - ref[1]).abs() / ref[1]).max())))
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), (c, shape)
        del x
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_graph_replay_equals_the_eager_launch(cuda, dtype):
    xs = [_input(c, dtype, True, shape=(1, None, *sp), seed=7, device=cuda)
          for c, sp in ((192, (112, 112, 80)), (256, (7, 7, 5)))]
    eager = [ec.gn_stats(x, GROUPS, f) for x in xs for f in (ec.GN_GROUP, ec.GN_CHANNEL_MEANS)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = [ec.gn_stats(x, GROUPS, f) for x in xs for f in (ec.GN_GROUP, ec.GN_CHANNEL_MEANS)]
    for _ in range(2):
        for mean, inv in out:
            mean.zero_()
            inv.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for (m, i), (em, ei) in zip(out, eager):
            assert torch.equal(m, em) and torch.equal(i, ei)


@pytest.mark.cuda
def test_a_production_forward_launches_71_and_a_train_step_none(cuda):
    """The production UNet in bf16 with fuse_conv and fuse_gn_silu: 71
    launches a forward (54 before K4b, 17 before K3); in fp32 its output
    within 1e-4 of the same forward with the plain statistics; a train
    step under remat launches none."""
    from fast_cwdm_tpu_torch.cli import common

    x = torch.randn((1, 112, 112, 80, 32), device=cuda).permute(0, 4, 1, 2, 3)
    t = torch.tensor([5], device=cuda)
    model = common.flagship(device=cuda, dtype=torch.bfloat16, fuse_gn_silu=True,
                            fuse_conv=True).eval()
    with torch.no_grad():
        before = ops.launch_counts()
        y = model(x, t)
        torch.cuda.synchronize()
        launched = ops.launches_since(before)
    assert torch.isfinite(y.float()).all()
    assert launched["gn_stats"] == 71 and launched["conv3d_fused_k4b"] == 54
    assert launched["affine_silu"] == 17

    model = common.flagship(device=cuda, dtype=torch.float32, fuse_gn_silu=True,
                            fuse_conv=True).eval()
    with torch.no_grad():
        for p in model.out.parameters():  # a nonzero output conv
            p.normal_(0.0, 0.02)
        y = model(x, t)
        saved = ec._gn_stats_kernel
        try:
            ec._gn_stats_kernel = ec.gn_stats_plain
            ref = model(x, t)
        finally:
            ec._gn_stats_kernel = saved
    assert float(ref.abs().max()) > 0
    assert float((y - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    del model, y, ref

    model = common.flagship(device=cuda, dtype=torch.bfloat16, fuse_gn_silu=True,
                            use_checkpoint=True).train()
    before = ops.launch_counts()
    loss = model(x, t).float().square().mean()
    loss.backward()
    torch.cuda.synchronize()
    launched = ops.launches_since(before)
    assert "gn_stats" not in launched and launched["affine_silu"] > 71
