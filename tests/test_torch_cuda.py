"""The hand-written CUDA kernels on the card: K1/K2/K3 and the fused conv
kernels behind K4a/K4b/K5 (mma.sync, wgmma at 64 and 32 output channels a
block, split-K, and the fp32 3×TF32 wgmma kernel), each against
its plain torch version, their wrappers' refusals (the fused conv's
backward included), the autograd pairs (K1/K2, K3 and its VJP), fuse_conv
UNets that reach K4b on each conv kernel (an fp32 one on the 3×TF32
kernel), a .ckpt round trip of a model on
the card, complete_dataset on the card, a train step on the card
against the same step on the CPU, the synthesis chain captured as a CUDA
graph against the eager chain (an attention UNet's too, and the unfused
x0 projection's, K2 and K1 every step), and a WavUNet's forward on the
card against the CPU.

Marked ``cuda``: skipped where no GPU is present. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from fast_cwdm_tpu_torch.cli import common, complete_dataset
from fast_cwdm_tpu_torch.data import nifti
from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.training import checkpoints
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict
from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(1, 16, 12, 8), (2, 3, 8, 10, 6)])
def test_haar_kernels_match_plain(gen, shape):
    x = torch.rand(shape, generator=gen, device="cuda")
    before = (wc.haar_dwt3.launches, wc.haar_idwt3.launches)
    y = wc.haar_dwt3(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, wc.haar_dwt3_plain(x), atol=1e-5, rtol=0)
    back = wc.haar_idwt3(y)
    torch.testing.assert_close(back, wc.haar_idwt3_plain(y), atol=1e-5, rtol=0)
    torch.testing.assert_close(back, x, atol=1e-5, rtol=0)
    assert (wc.haar_dwt3.launches, wc.haar_idwt3.launches) == (before[0] + 1, before[1] + 1)


def test_dwt3_flat_routes_to_the_kernel(gen):
    x = torch.rand((1, 8, 8, 8, 1), generator=gen, device="cuda")
    before = wc.haar_dwt3.launches
    ours = wv.dwt3_flat(x)
    assert wc.haar_dwt3.launches == before + 1
    torch.testing.assert_close(ours, wv.dwt3_flat(x, impl="xla"), atol=1e-5, rtol=0)


def test_autograd_pair_backward_launches_the_other_kernel(gen):
    x = torch.rand((1, 8, 8, 8), generator=gen, device="cuda", requires_grad=True)
    w = torch.rand((1, 4, 4, 4, 8), generator=gen, device="cuda")
    before = wc.haar_idwt3.launches
    (wc.HaarDWT3.apply(x) * w).sum().backward()
    assert wc.haar_idwt3.launches == before + 1
    torch.testing.assert_close(x.grad, wc.haar_idwt3_plain(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 6, 6, 4), (1, 3, 5, 3, 3)])
def test_affine_silu_matches_plain(gen, dtype, channels_last, shape):
    """Vector path (64 channels) and element path (3 channels, odd sizes);
    the same fp32 operations on both sides, so equal bit for bit."""
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    a = torch.randn(shape[:2], generator=gen, device="cuda")
    b = torch.randn(shape[:2], generator=gen, device="cuda")
    before = ec.affine_silu.launches
    y = ec.affine_silu(x, a, b)
    torch.cuda.synchronize()
    assert ec.affine_silu.launches == before + 1
    assert y.dtype == dtype and y.stride() == x.stride()
    torch.testing.assert_close(y, ec.affine_silu_plain(x, a, b), atol=0, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.rand((1, 8, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        wc.haar_dwt3(x.double())
    with pytest.raises(ValueError):
        wc.haar_dwt3(x.transpose(1, 2))
    with pytest.raises(ValueError):
        wc.haar_idwt3(torch.zeros((1, 2, 2, 2, 8), device="cuda").transpose(1, 2))
    h = torch.zeros((1, 8, 4, 4, 4), device="cuda")
    with pytest.raises(TypeError):
        ec.affine_silu(h.half(), torch.ones(1, 8, device="cuda"), torch.zeros(1, 8, device="cuda"))
    with pytest.raises(ValueError):
        ec.affine_silu(h.transpose(2, 3), torch.ones(1, 8, device="cuda"),
                       torch.zeros(1, 8, device="cuda"))
    with pytest.raises(ValueError):
        ec.affine_silu(h, torch.ones(8, device="cuda"), torch.zeros(1, 8, device="cuda"))


def _conv_case(gen, dtype, bsz, ci, co, spatial, gn_kind):
    x = torch.randn((bsz, *spatial, ci), generator=gen, device="cuda").to(dtype)
    x = x.permute(0, 4, 1, 2, 3)  # channels_last_3d
    w = 0.1 * torch.randn((3, 3, 3, ci, co), generator=gen, device="cuda")
    b = 0.1 * torch.randn(co, generator=gen, device="cuda")
    gn = None
    if gn_kind:
        lead = (bsz, ci) if gn_kind == "batch" else (ci,)
        mean, inv = (tc.group_stats(x, 8) if gn_kind == "batch" else
                     (0.1 * torch.randn(ci, generator=gen, device="cuda"),
                      0.5 + torch.rand(ci, generator=gen, device="cuda")))
        scale = 1.0 + 0.2 * torch.randn(lead, generator=gen, device="cuda")
        bias = 0.5 + 0.1 * torch.randn(lead, generator=gen, device="cuda")  # pro(0) != 0
        gn = (mean, inv, scale, bias)
    return x, w, b, gn


# odd X/Y/Z and Z longer than one 16-voxel tile, Ci not a multiple of 16,
# Co under one 64-wide tile, B = 2 with per-(B, C) statistics
CONV_CASES = [
    (1, 16, 16, (5, 6, 7), "channel"),
    (2, 24, 8, (3, 4, 17), "batch"),
    (2, 64, 72, (4, 5, 9), None),
    (1, 32, 64, (7, 7, 5), "batch"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv3d_fused_matches_plain(gen, dtype, case):
    """K4a and K4b against the plain version, within tc.tol_ratio (one ulp
    of the output plus 2^-16 of conv(|act|, |w|))."""
    x, w, b, gn = _conv_case(gen, dtype, *case)
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    for block_x, counter in ((2, "launches_k4b"), (None, "launches_k4a")):
        before = getattr(tc.conv3d_fused, counter)
        y = tc.conv3d_fused(x, w, b, gn=gn, block_x=block_x)
        torch.cuda.synchronize()
        assert getattr(tc.conv3d_fused, counter) == before + 1
        assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last_3d)
        assert tc.tol_ratio(y, ref, x, w, gn) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_fused_v4_matches_plain(gen, dtype):
    """K5's epilogue: + (b + temb) + skip, B = 2, Ci != Co."""
    x, w, b, gn = _conv_case(gen, dtype, 2, 48, 32, (3, 5, 11), "batch")
    temb = torch.randn((2, 32), generator=gen, device="cuda")
    skip = torch.randn((2, 3, 5, 11, 32), generator=gen, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
    before = tc.conv3d_fused_v4.launches
    y = tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip)
    torch.cuda.synchronize()
    assert tc.conv3d_fused_v4.launches == before + 1
    ref = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    # kernel and plain version add the epilogue in the same order
    assert tc.tol_ratio(y, ref, x, w, gn) <= 1.0


def test_fuse_conv_unet_launches_k4b_only(gen, monkeypatch):
    """A fuse_conv UNet on the card raises K4b's count by 2 per fused
    ResBlock, never calls the plain version, and agrees with the same
    model on the CPU (fp32, TF32 off)."""
    cfg = dict(image_size=16, in_channels=16, model_channels=16, out_channels=8,
               num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
               num_groups=8, resblock_updown=True, bottleneck_attention=False,
               resample_2d=False, fuse_conv=True)
    torch.manual_seed(0)
    cpu = UNetModel(**cfg).eval()
    for p in cpu.parameters():  # nonzero output convs
        torch.nn.init.normal_(p, std=0.1)
    card = UNetModel(**cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card.cuda()
    n_fused = sum(getattr(m, "fuse", False) for m in card.modules())
    assert n_fused == 8
    x = torch.randn((1, 8, 8, 8, 16), generator=gen, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([3], device="cuda")
    with torch.no_grad():
        ref = cpu(x.cpu(), t.cpu())
        monkeypatch.setattr(tc, "conv3d_fused_plain", None)  # a call would raise
        before = tc.conv3d_fused.launches_k4b
        y = card(x, t)
        torch.cuda.synchronize()
    assert tc.conv3d_fused.launches_k4b == before + 2 * n_fused
    torch.testing.assert_close(y.cpu(), ref, atol=1e-4, rtol=0)


# (B, Ci, Co, spatial, gn): 64→64, 128→64 and 192→64 on a grid ragged in
# Y and Z (neither a multiple of the 8×8×8 block), B = 2 with per-(B, C)
# statistics, and a plain conv
WGMMA_CASES = [
    (1, 64, 64, (9, 12, 10), "channel"),
    (1, 128, 64, (8, 13, 11), "batch"),
    (1, 192, 64, (10, 9, 14), "channel"),
    (2, 64, 128, (9, 10, 12), "batch"),
    (2, 32, 64, (5, 7, 9), None),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_conv3d_wgmma_matches_plain(gen, case):
    """The wgmma kernel (conv3d_wgmma.cu) against the plain version, within
    tc.tol_ratio, at shapes where route() picks the other kernel: packed
    by the wrapper, handed a packed weight, and handed a getter of one;
    each launch counted on that kernel."""
    x, w, b, gn = _conv_case(gen, torch.bfloat16, *case)
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    wp = tc.pack_wgmma_weights(w)
    before = tc.kernel_launches["conv3d_wgmma"]
    for y in (tc._launch("k4b", x, w, b, gn, None, None, kernel="wgmma"),
              tc._launch("k4a", x, w, b, gn, None, None, wp, "wgmma"),
              tc._launch("getter", x, w, b, gn, None, None, lambda bn: wp, "wgmma")):
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last_3d)
        assert tc.tol_ratio(y, ref, x, w, gn) <= 1.0
    assert tc.kernel_launches["conv3d_wgmma"] == before + 3


# (B, Ci, Co, spatial, gn): the 32-wide wgmma kernel at Co 32 (one output
# block) ragged in X, Y and Z, Co 96 (three blocks) with per-(B, C)
# statistics at B = 2, a plain conv, and Ci 192
WGMMA_N32_CASES = [
    (1, 64, 32, (9, 12, 10), "channel"),
    (2, 32, 96, (10, 9, 11), "batch"),
    (1, 16, 32, (8, 8, 17), None),
    (1, 192, 32, (9, 8, 8), "channel"),
]


@pytest.mark.parametrize("case", WGMMA_N32_CASES)
def test_conv3d_wgmma_n32_matches_plain(gen, case):
    """The 32-wide wgmma kernel (conv3d_wgmma_n32 in conv3d_wgmma.cu)
    against the plain version within tc.tol_ratio, packed by the wrapper,
    handed a 32-wide pack and a getter called with its width; each launch
    counted on that kernel alone; two launches bit for bit; a 64-wide pack
    refused."""
    x, w, b, gn = _conv_case(gen, torch.bfloat16, *case)
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    wp = tc.pack_wgmma_weights(w, 32)
    widths = []

    def getter(bn):
        widths.append(bn)
        return wp

    before = dict(tc.kernel_launches)
    ys = [tc._launch("k4b", x, w, b, gn, None, None, kernel="wgmma_n32"),
          tc._launch("k4a", x, w, b, gn, None, None, wp, "wgmma_n32"),
          tc._launch("getter", x, w, b, gn, None, None, getter, "wgmma_n32")]
    torch.cuda.synchronize()
    for y in ys:
        assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last_3d)
        assert tc.tol_ratio(y, ref, x, w, gn) <= 1.0
        assert torch.equal(y, ys[0])
    assert widths == [32]
    for k, n in tc.kernel_launches.items():
        assert n == before[k] + (3 if k == "conv3d_wgmma_n32" else 0), k
    if case[2] % 64 == 0:
        with pytest.raises(ValueError):
            tc._launch("k4b", x, w, b, gn, None, None, tc.pack_wgmma_weights(w), "wgmma_n32")


def test_conv3d_wgmma_n32_is_the_route_at_co_32(gen):
    """Where route() picks the 32-wide kernel (Co 32, 64 blocks of 8³), the
    entry points launch it: K4b with the prologue and K5 with temb and
    skip, each against its plain version."""
    bsz, ci, co, sp = 1, 32, 32, (32, 32, 32)
    assert tc.route(torch.bfloat16, bsz, ci, co, *sp) == "wgmma_n32"
    x, w, b, gn = _conv_case(gen, torch.bfloat16, bsz, ci, co, sp, "batch")
    temb = torch.randn((bsz, co), generator=gen, device="cuda")
    skip = torch.randn((bsz, *sp, co), generator=gen, device="cuda").bfloat16().permute(0, 4, 1, 2, 3)
    before = tc.kernel_launches["conv3d_wgmma_n32"]
    y = tc.conv3d_fused(x, w, b, gn=gn, block_x=2)
    y5 = tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip)
    torch.cuda.synchronize()
    assert tc.kernel_launches["conv3d_wgmma_n32"] == before + 2
    assert tc.tol_ratio(y, tc.conv3d_fused_plain(x, w, b, gn=gn), x, w, gn) <= 1.0
    ref5 = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    assert tc.tol_ratio(y5, ref5, x, w, gn) <= 1.0


def test_conv3d_wgmma_v4_matches_plain(gen):
    """K5 on the wgmma kernel: + (b + temb) + skip, B = 2, Ci != Co."""
    x, w, b, gn = _conv_case(gen, torch.bfloat16, 2, 96, 64, (9, 11, 10), "batch")
    temb = torch.randn((2, 64), generator=gen, device="cuda")
    skip = torch.randn((2, 9, 11, 10, 64), generator=gen, device="cuda").bfloat16().permute(0, 4, 1, 2, 3)
    before = tc.kernel_launches["conv3d_wgmma"]
    y = tc._launch("k5", x, w, b, gn, temb, skip, kernel="wgmma")
    torch.cuda.synchronize()
    assert tc.kernel_launches["conv3d_wgmma"] == before + 1
    ref = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    assert tc.tol_ratio(y, ref, x, w, gn) <= 1.0


def test_wgmma_reciprocal_is_the_ieee_quotient(gen):
    """The wgmma kernel's prologue takes 1/(1 + expf(-u)) from a branch-free
    reciprocal; it equals IEEE 1.0f / d for every float d in [1, 2^126)."""
    assert tc.recip_mismatches() == 0


def test_fuse_conv_unet_launches_wgmma(gen, monkeypatch):
    """A bf16 fuse_conv UNet whose convs all route to the wgmma kernel
    (WG_MIN_BLOCKS lowered for its small grid) launches it at every fused
    conv, never the plain version; with WG_MIN_BLOCKS out of reach every
    conv goes to the split-K kernel instead, and with the route forced to
    the 32-wide wgmma kernel (the module's packed weight at width 32) to
    that; each agrees with the same model on the mma.sync kernel (the
    route forced there) to within twice that model's own bf16 error
    against fp32 on the CPU."""
    cfg = dict(image_size=16, in_channels=16, model_channels=64, out_channels=8,
               num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
               num_groups=8, resblock_updown=True, bottleneck_attention=False,
               resample_2d=False, fuse_conv=True)
    torch.manual_seed(0)
    cpu = UNetModel(**cfg).eval()
    for p in cpu.parameters():  # nonzero output convs
        torch.nn.init.normal_(p, std=0.05)
    card = UNetModel(**cfg, dtype=torch.bfloat16).eval()
    card.load_state_dict(cpu.state_dict())
    card.cuda()
    n_fused = sum(getattr(m, "fuse", False) for m in card.modules())
    x = torch.randn((1, 16, 16, 16, 16), generator=gen, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([3], device="cuda")
    outs = {}
    with torch.no_grad():
        ref32 = cpu(x.cpu(), t.cpu())
        monkeypatch.setattr(tc, "conv3d_fused_plain", None)  # a call would raise
        for kernel, patch in (("wgmma", ("WG_MIN_BLOCKS", 1)),
                              ("splitk", ("WG_MIN_BLOCKS", 10**9)),
                              ("wgmma_n32", ("route", lambda *shape: "wgmma_n32")),
                              ("mma_sync", ("route", lambda *shape: "mma_sync"))):
            monkeypatch.setattr(tc, *patch)
            before = dict(tc.kernel_launches)
            outs[kernel] = card(x, t)
            torch.cuda.synchronize()
            for k, n in tc.kernel_launches.items():
                assert n == before[k] + (2 * n_fused if k == f"conv3d_{kernel}" else 0), k
    assert all(torch.isfinite(outs[k]).all() for k in ("wgmma", "splitk", "wgmma_n32"))
    bf16_err = float((outs["mma_sync"].cpu() - ref32).abs().max())
    for kernel in ("wgmma", "splitk", "wgmma_n32"):
        assert float((outs[kernel] - outs["mma_sync"]).abs().max()) <= 2 * bf16_err


# (B, Ci, Co, spatial, gn): the 3×TF32 kernel at 64→64 ragged in X, Y and
# Z, 128→128 with per-(B, C) statistics at B = 2, Ci 24 (off the 16 grid,
# on the 8 grid), a plain conv
TF32_CASES = [
    (1, 64, 64, (9, 12, 10), "channel"),
    (2, 128, 128, (8, 9, 11), "batch"),
    (1, 24, 64, (10, 9, 14), "channel"),
    (1, 32, 64, (5, 7, 9), None),
]


@pytest.mark.parametrize("case", TF32_CASES)
def test_conv3d_wgmma_tf32_matches_plain(gen, case):
    """The 3×TF32 kernel (conv3d_tf32.cu) against the plain version within
    tc.tol_ratio through K4b, K4a and K5 (temb + skip): packed by the
    wrapper, handed a pack, and a getter called with (64, torch.float32);
    two launches bit for bit; each launch counted on that kernel alone; a
    bf16 pack and a bf16 input refused."""
    x, w, b, gn = _conv_case(gen, torch.float32, *case)
    bsz, ci, co, sp = case[:4]
    temb = torch.randn((bsz, co), generator=gen, device="cuda")
    skip = torch.randn((bsz, *sp, co), generator=gen, device="cuda").permute(0, 4, 1, 2, 3)
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    ref5 = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    wp = tc.pack_tf32_weights(w)
    calls = []

    def getter(*args):
        calls.append(args)
        return wp

    before = dict(tc.kernel_launches)
    ys = [tc._launch("k4b", x, w, b, gn, None, None, kernel="wgmma_tf32"),
          tc._launch("k4a", x, w, b, gn, None, None, wp, "wgmma_tf32"),
          tc._launch("getter", x, w, b, gn, None, None, getter, "wgmma_tf32")]
    y5 = [tc._launch("k5", x, w, b, gn, temb, skip, wp, "wgmma_tf32") for _ in range(2)]
    torch.cuda.synchronize()
    for y in ys:
        assert y.dtype == torch.float32 and y.is_contiguous(memory_format=torch.channels_last_3d)
        assert tc.tol_ratio(y, ref, x, w, gn) <= 1.0
        assert torch.equal(y, ys[0])
    assert tc.tol_ratio(y5[0], ref5, x, w, gn) <= 1.0 and torch.equal(y5[0], y5[1])
    assert calls == [(64, torch.float32)]
    for k, n in tc.kernel_launches.items():
        assert n == before[k] + (5 if k == "conv3d_wgmma_tf32" else 0), k
    if ci % 16 == 0:
        with pytest.raises(ValueError):
            tc._launch("k4b", x, w, b, gn, None, None, tc.pack_wgmma_weights(w), "wgmma_tf32")
    with pytest.raises(ValueError):
        tc._launch("k4b", x.bfloat16(), w, b, gn, None, None, kernel="wgmma_tf32")


def test_conv3d_wgmma_tf32_is_the_fp32_route(gen):
    """Where route() picks the 3×TF32 kernel (fp32, 32³ at Co 64: 128
    blocks of 4×8×8), the entry points launch it: K4b with the prologue, K4a, and K5
    with temb and skip, each against its plain version; the kernel's
    split rounds as the weights' (tf32_round) and its tensor cores read
    the low part truncated, as the CPU tests model it."""
    bsz, ci, co, sp = 1, 32, 64, (32, 32, 32)
    assert tc.route(torch.float32, bsz, ci, co, *sp) == "wgmma_tf32"
    x, w, b, gn = _conv_case(gen, torch.float32, bsz, ci, co, sp, "batch")
    temb = torch.randn((bsz, co), generator=gen, device="cuda")
    skip = torch.randn((bsz, *sp, co), generator=gen, device="cuda").permute(0, 4, 1, 2, 3)
    before = tc.kernel_launches["conv3d_wgmma_tf32"]
    ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
    for y in (tc.conv3d_fused(x, w, b, gn=gn, block_x=2), tc.conv3d_fused(x, w, b, gn=gn)):
        assert tc.tol_ratio(y, ref, x, w, gn) <= 1.0
    y5 = tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip)
    torch.cuda.synchronize()
    assert tc.kernel_launches["conv3d_wgmma_tf32"] == before + 3
    ref5 = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    assert tc.tol_ratio(y5, ref5, x, w, gn) <= 1.0
    assert tc.tf32_rna_mismatches()[0] == 0
    assert tc.tf32_read_mode()["mode"] == "truncate"


def test_fp32_fuse_conv_unet_runs_the_tf32_kernel(gen, monkeypatch):
    """An fp32 fuse_conv UNet with the production widths of levels 0-1 on a
    32³ latent: every fused conv launches K4b on the 3×TF32 kernel (128
    and 32 blocks), never the plain version; the forward agrees with the
    unfused fp32 forward on the card (TF32 off) within 1e-4 of its
    scale."""
    cfg = dict(image_size=32, in_channels=32, model_channels=64, out_channels=8,
               num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
               num_groups=32, resblock_updown=True, bottleneck_attention=False,
               resample_2d=False)
    torch.manual_seed(0)
    unfused = UNetModel(**cfg).eval()
    for p in unfused.parameters():  # nonzero output convs
        torch.nn.init.normal_(p, std=0.05)
    fused = UNetModel(**cfg, fuse_conv=True).eval()
    fused.load_state_dict(unfused.state_dict())
    unfused.cuda()
    fused.cuda()
    n_fused = sum(getattr(m, "fuse", False) for m in fused.modules())
    x = torch.randn((1, 32, 32, 32, 32), generator=gen, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([3], device="cuda")
    with torch.no_grad():
        ref = unfused(x, t)
        monkeypatch.setattr(tc, "conv3d_fused_plain", None)  # a call would raise
        before, k4b = dict(tc.kernel_launches), tc.conv3d_fused.launches_k4b
        y = fused(x, t)
        torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in tc.kernel_launches.items()}
    assert tc.conv3d_fused.launches_k4b == k4b + 2 * n_fused
    assert launched["conv3d_wgmma_tf32"] == 2 * n_fused
    assert bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


# (B, Ci, Co, spatial, gn, epilogue): the deep levels' most-launched shapes,
# 14×14×10 384→256, a ragged shape, tiles on one z-line and on two
# y-lines (1×2×130), B = 2 with per-(B, C) statistics, K4b without the
# prologue, K5 with temb + skip
SPLITK_CASES = [
    (1, 256, 256, (7, 7, 5), "channel", False),
    (1, 512, 256, (7, 7, 5), "channel", False),
    (1, 384, 256, (14, 14, 10), "channel", False),
    (1, 32, 64, (5, 7, 9), "channel", False),
    (1, 16, 64, (1, 2, 130), "channel", False),
    (2, 128, 128, (7, 6, 9), "batch", False),
    (1, 256, 256, (14, 14, 10), None, False),
    (2, 256, 256, (7, 7, 5), "batch", True),
]


@pytest.mark.parametrize("case", SPLITK_CASES)
def test_conv3d_splitk_matches_plain(gen, case):
    """The split-K kernel (conv3d_splitk.cu), where route() sends these
    shapes, against the plain version within tc.tol_ratio; two launches
    bit-identical; each call counted once; a w_packed getter called and
    its weight read; the entry point on the same kernel."""
    bsz, ci, co, sp, gn_kind, epilogue = case
    x, w, b, gn = _conv_case(gen, torch.bfloat16, bsz, ci, co, sp, gn_kind)
    temb = skip = None
    if epilogue:
        temb = torch.randn((bsz, co), generator=gen, device="cuda")
        skip = torch.randn((bsz, *sp, co), generator=gen, device="cuda").bfloat16()
        skip = skip.permute(0, 4, 1, 2, 3)
    assert tc.route(torch.bfloat16, bsz, ci, co, *sp) == "splitk"
    ref = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
    wp = tc.pack_wgmma_weights(w)
    calls = []

    def getter(bn):
        calls.append(bn)
        return wp

    before = tc.kernel_launches["conv3d_splitk"]
    ys = [tc._launch("k4b", x, w, b, gn, temb, skip, getter) for _ in range(2)]
    torch.cuda.synchronize()
    assert tc.kernel_launches["conv3d_splitk"] == before + 2 and calls == [64, 64]
    assert ys[0].dtype == torch.bfloat16 and ys[0].is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(ys[0], ys[1])  # no atomics: the same bits every launch
    assert tc.tol_ratio(ys[0], ref, x, w, gn) <= 1.0
    negated = tc._launch("k4b", x, w, b, gn, temb, skip, lambda bn: tc.pack_wgmma_weights(-w, bn))
    assert not torch.equal(negated, ys[0])
    if epilogue:
        y = tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip, w_packed=wp)
    else:
        y = tc.conv3d_fused(x, w, b, gn=gn, block_x=2)  # packed by the wrapper
    assert torch.equal(y, ys[0])
    assert tc.kernel_launches["conv3d_splitk"] == before + 4


def test_conv3d_wrappers_refuse_what_the_kernel_does_not_take(gen):
    x, w, b, _ = _conv_case(gen, torch.bfloat16, 1, 16, 16, (4, 4, 4), None)
    with pytest.raises(TypeError):
        tc.conv3d_fused(x.half(), w, b)
    with pytest.raises(ValueError):
        tc.conv3d_fused(x.contiguous(), w, b)  # NCDHW-contiguous memory
    with pytest.raises(ValueError):
        tc.conv3d_fused(x[:, :12], w[:, :, :, :12], b)  # Ci % 8 != 0
    with pytest.raises(ValueError):
        tc.conv3d_fused_v4(x, w, b, skip=torch.zeros_like(x, dtype=torch.float32))
    with pytest.raises(ValueError):
        tc._launch("k4b", x.float(), w, b, None, None, None, kernel="wgmma")  # bf16 only
    with pytest.raises(ValueError):
        tc._launch("k4b", x, w, b, None, None, None, kernel="wgmma")  # Co = 16, not 64
    with pytest.raises(ValueError):
        tc._launch("k4b", x, w, b, None, None, None, kernel="plain")
    with pytest.raises(ValueError):
        tc._launch("k4b", x.float(), w, b, None, None, None, kernel="splitk")  # bf16 only
    with pytest.raises(ValueError):
        tc._launch("k4b", x, w, b, None, None, None, kernel="splitk")  # Co = 16, not 64


def _vjp_sum_tol(x, g, a, b):
    """The tolerance of ga and gb: 1e-5 of the sum of the terms' magnitudes
    (the kernel sums in another order than torch)."""
    _, ga_abs, gb_abs = ec.affine_silu_bwd_plain(x.abs(), g.abs(), a.abs(), b.abs())
    return 1e-5 * ga_abs + 1e-30, 1e-5 * gb_abs + 1e-30


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 6, 6, 4), (1, 3, 5, 3, 3), (1, 192, 4, 5, 4),
                                   (1, 512, 7, 7, 5)])
def test_affine_silu_vjp_kernel_matches_plain(gen, dtype, channels_last, shape):
    """The VJP kernel against affine_silu_bwd_plain: gx bit for bit (the same
    fp32 operations, each rounded once), ga and gb within 1e-5 of the sum of
    the terms' magnitudes (summation order), two launches bit for bit."""
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    a = torch.randn(shape[:2], generator=gen, device="cuda")
    b = torch.randn(shape[:2], generator=gen, device="cuda")
    before = ec.affine_silu_bwd.launches
    gx, ga, gb = ec.affine_silu_bwd(x, g, a, b)
    again = ec.affine_silu_bwd(x, g, a, b)
    torch.cuda.synchronize()
    assert ec.affine_silu_bwd.launches == before + 2
    assert gx.dtype == dtype and gx.stride() == x.stride()
    rx, ra, rb = ec.affine_silu_bwd_plain(x, g, a, b)
    torch.testing.assert_close(gx, rx, atol=0, rtol=0)
    ta, tb = _vjp_sum_tol(x, g, a, b)
    assert bool(((ga - ra).abs() <= ta).all()), float(((ga - ra).abs() / ta).max())
    assert bool(((gb - rb).abs() <= tb).all()), float(((gb - rb).abs() / tb).max())
    for ours, other in zip((gx, ga, gb), again):
        assert torch.equal(ours, other)


def test_affine_silu_backward_runs_the_vjp_kernel(gen):
    """backward() through affine_silu (x, and a scale that requires grad as
    GroupNorm32's does) launches the VJP kernel once and gives the plain
    VJP's gradients; under inference_mode the forward runs alone."""
    x = torch.randn((1, 16, 4, 5, 6), generator=gen, device="cuda", requires_grad=True)
    scale = torch.randn(16, generator=gen, device="cuda", requires_grad=True)
    rstd = torch.rand((1, 16), generator=gen, device="cuda") + 0.5
    b = torch.randn((1, 16), generator=gen, device="cuda")
    w = torch.randn((1, 16, 4, 5, 6), generator=gen, device="cuda")
    before = (ec.affine_silu.launches, ec.affine_silu_bwd.launches)
    a = rstd * scale[None]
    (ec.affine_silu(x, a, b) * w).sum().backward()
    torch.cuda.synchronize()
    assert (ec.affine_silu.launches, ec.affine_silu_bwd.launches) == (before[0] + 1, before[1] + 1)
    gx, ga, _ = ec.affine_silu_bwd_plain(x.detach(), w, a.detach(), b)
    torch.testing.assert_close(x.grad, gx, atol=0, rtol=0)
    torch.testing.assert_close(scale.grad, (ga * rstd)[0], atol=1e-5, rtol=1e-5)
    with torch.inference_mode():
        y = ec.affine_silu(x, a, b)
    torch.testing.assert_close(y, ec.affine_silu_plain(x.detach(), a.detach(), b), atol=0, rtol=0)


def test_groupnorm_silu_grads_on_the_card_match_the_cpu(gen):
    """GroupNorm32(act="silu") under backward: K3 and its VJP on the card,
    the plain versions on the CPU, fp32; gradients to x, scale and bias."""
    from fast_cwdm_tpu_torch.models.nn import GroupNorm32

    x = torch.randn((2, 32, 6, 5, 4), generator=gen, device="cuda")
    x = x.contiguous(memory_format=torch.channels_last_3d)
    w = torch.randn(x.shape, generator=gen, device="cuda")
    grads = {}
    for dev in ("cpu", "cuda"):
        gn = GroupNorm32(8, 32).to(dev)
        with torch.no_grad():
            gn.weight.add_(0.1 * torch.arange(32.0, device=dev) / 32)
            gn.bias.add_(0.05)
        xx = x.detach().to(dev).requires_grad_()
        before = ec.affine_silu_bwd.launches
        (gn(xx, act="silu") * w.to(dev)).sum().backward()
        assert ec.affine_silu_bwd.launches == before + (dev == "cuda")
        grads[dev] = [t.detach().cpu() for t in (xx.grad, gn.weight.grad, gn.bias.grad)]
    for ours, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(ours, ref, atol=1e-4, rtol=1e-4)


def test_fused_conv_refuses_backward(gen):
    """The fused conv kernels have no backward (nor has the JAX package):
    backward() through conv3d_fused or conv3d_fused_v4 raises; under
    inference_mode the same calls run within tolerance."""
    x, w, b, gn = _conv_case(gen, torch.bfloat16, 1, 16, 64, (4, 5, 6), "channel")
    w = w.requires_grad_()
    calls = {"k4b": lambda: tc.conv3d_fused(x, w, b, gn=gn, block_x=2),
             "k5": lambda: tc.conv3d_fused_v4(x, w, b, gn=gn)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call().float().sum().backward()
        with torch.inference_mode():
            y = call()
        ref = tc.conv3d_fused_plain(x, w.detach(), b, gn=gn)
        assert tc.tol_ratio(y, ref, x, w.detach(), gn) <= 1.0, name


def _tiny_cfg(**kw):
    return common.production_config(
        num_channels=16, num_res_blocks=1, channel_mult="1,2", num_groups=8, image_size=8,
        diffusion_steps=4, sample_schedule="sampled", dtype="float32", **kw)


def test_ckpt_round_trip_of_a_model_on_the_card(gen, tmp_path):
    """A model on the card → its JAX-layout params → .ckpt → load_params
    into a fresh model on the card: every tensor bit for bit, the EMA shadow
    picked by use_ema, and the same output."""
    cfg = _tiny_cfg()
    model, _ = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.cuda().eval()
    params = jax_params_from_state_dict(model.state_dict(), model)
    ema = jax_params_from_state_dict({k: 0.5 * v for k, v in model.state_dict().items()}, model)
    path = str(tmp_path / "brats_t1c_BEST_sampled_4.ckpt")
    checkpoints.save_checkpoint(path, {"params": params, "ema_params": (ema,), "step": 1}, cfg)
    for use_ema, scale in ((False, 1.0), (True, 0.5)):
        fresh, _ = common.build_model_and_diffusion(cfg)
        _, applied = common.load_params_ex(path, fresh, use_ema=use_ema)
        fresh.cuda().eval()
        assert applied == use_ema
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], scale * v), k
    x = torch.randn((1, 32, 8, 8, 8), generator=gen, device="cuda")
    t = torch.tensor([2], device="cuda")
    fresh, _ = common.build_model_and_diffusion(cfg)
    common.load_params(path, fresh)
    with torch.inference_mode():  # the same weights; cuDNN may pick another algorithm
        torch.testing.assert_close(fresh.cuda().eval()(x, t), model(x, t), atol=1e-5, rtol=0)


def test_complete_dataset_on_the_card(gen, tmp_path):
    """complete_dataset with --device cuda on a tiny tree and a port-written
    .ckpt: the missing modality written at the source geometry with a zero
    border, the present files passed through, none failed; the Haar kernels
    launched."""
    cfg = _tiny_cfg()
    model, _ = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    params = jax_params_from_state_dict(sd, model)
    ckpt_dir = str(tmp_path / "ckpt")
    checkpoints.save_checkpoint(os.path.join(ckpt_dir, "brats_t1c_BEST_sampled_4.ckpt"),
                                {"params": params, "ema_params": (), "step": 0}, cfg)
    rng = np.random.default_rng(0)
    case = tmp_path / "in" / "00001"
    os.makedirs(case)
    for m in ("t1n", "t2w", "t2f"):
        vol = (rng.random((24, 24, 15)) * 900 + 100).astype(np.float32)
        nifti.save(nifti.Nifti1Image(vol, np.eye(4)), str(case / f"BraTS-GLI-00001-000-{m}.nii.gz"))
    before = wc.haar_dwt3.launches, wc.haar_idwt3.launches
    res = complete_dataset.main([f"--input_dir={tmp_path / 'in'}", f"--output_dir={tmp_path / 'out'}",
                                 f"--checkpoint_dir={ckpt_dir}", "--device=cuda"])
    assert res["failed"] == [] and list(res["seconds"]) == ["00001"]
    assert (wc.haar_dwt3.launches - before[0], wc.haar_idwt3.launches - before[1]) == (3, 1)
    out = tmp_path / "out" / "00001"
    assert sorted(os.listdir(out)) == sorted(os.listdir(case) + ["00001-t1c.nii.gz"])
    for f in os.listdir(case):
        assert (out / f).read_bytes() == (case / f).read_bytes()
    vol = nifti.load(str(out / "00001-t1c.nii.gz")).get_fdata()
    assert vol.shape == (24, 24, 15) and np.isfinite(vol).all()
    assert vol.min() >= 0.0 and vol.max() <= 1.0 and not vol[:8].any() and not vol[:, -8:].any()


@pytest.mark.parametrize("fuse_gn_silu", [False, True])
def test_train_step_on_the_card_matches_the_cpu(gen, fuse_gn_silu):
    """One train step of the tiny fp32 UNet with use_checkpoint (every
    ResBlock recomputed) on the card and on the CPU (plain versions): same
    weights, batch, t and noise, TF32 off. Loss and subband MSE atol 1e-5;
    parameters after AdamW (eps 1e-3, as the CPU parity tests against JAX)
    within 5e-3·lr plus two ulps. On the card: K1 5 launches (4 modalities
    and the noise), K2 1, and with fuse_gn_silu K3 at 21 sites plus 20 more
    in the recomputation, its VJP 21 times."""
    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from fast_cwdm_tpu_torch.training import state as tstate
    from fast_cwdm_tpu_torch.training import train

    cfg = _tiny_cfg(fuse_gn_silu=fuse_gn_silu, use_checkpoint=True, remat_max_ds=0)
    rng = np.random.default_rng(0)
    batch = {m: torch.from_numpy(rng.random((2, 8, 8, 8, 1)).astype(np.float32))
             for m in ("t1n", "t1c", "t2w", "t2f")}
    noise = torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32))
    t = torch.tensor([3, 1])
    out = {}
    for dev in ("cpu", "cuda"):
        model, _ = common.build_model_and_diffusion(cfg)
        sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(dev)
        diffusion = GaussianDiffusion.named("linear", 4, "sampled", mode="i2i")
        opt = train.make_optimizer(1e-4, eps=1e-3)
        step = train.make_train_step(model, diffusion, opt, contr="t1n", mode="i2i")
        state = tstate.TrainState.create(model, opt, ema_rates=(0.99,))
        before = (wc.haar_dwt3.launches, wc.haar_idwt3.launches, ec.affine_silu.launches,
                  ec.affine_silu_bwd.launches)
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()}, t=t.to(dev),
                        noise_img=noise.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            got = tuple(after - b for after, b in zip(
                (wc.haar_dwt3.launches, wc.haar_idwt3.launches, ec.affine_silu.launches,
                 ec.affine_silu_bwd.launches), before))
            assert got == ((5, 1, 41, 21) if fuse_gn_silu else (5, 1, 0, 0)), got
        out[dev] = ({k: v.detach().cpu() for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in state.params.items()})
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    for k in ("loss", "mse_wav"):
        torch.testing.assert_close(mg[k], mc[k], atol=1e-5, rtol=0)
    for k, v in pc.items():
        tol = 5e-3 * 1e-4 + 2.0**-22 * v.abs()
        assert bool(((pg[k] - v).abs() <= tol).all()), k


def test_batches_reach_the_card(gen):
    """prefetch_to_device (pinned host copies on a side stream, the
    consumer's stream waiting on each) and device_resident_batches (each
    case copied once, then served from the card) give the host batches'
    values on the card, in order."""
    from fast_cwdm_tpu_torch.data import loader

    rng = np.random.default_rng(0)
    items = [{m: rng.random((6, 6, 4, 1)).astype(np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
             for _ in range(3)]
    for it in items:
        it["missing"] = "none"
    batches = [{k: v[None] for k, v in it.items() if k != "missing"} for it in items]
    got = list(loader.prefetch_to_device(iter(batches), size=2, device="cuda"))
    cache: dict = {}
    resident = list(loader.device_resident_batches(items, 1, device="cuda", cache=cache))
    again = list(loader.device_resident_batches(items, 1, device="cuda", cache=cache))
    for b, g, r, a in zip(batches, got, resident, again):
        for k, v in b.items():
            assert g[k].is_cuda and np.array_equal(g[k].cpu().numpy(), v)
            assert r[k].is_cuda and np.array_equal(r[k].cpu().numpy(), v)
            assert a[k] is r[k]  # served from the cache


def _graph_case(flags):
    """A bf16 UNet with the production widths at levels 0-1 (64 and 128
    channels) on a 32³ latent, seeded weights, a 6-step sampled schedule:
    with fuse_conv its level-0 convs take the wgmma kernel and its level-1
    convs the split-K kernel; a condition from seeded 64³ volumes."""
    cfg = common.production_config(num_res_blocks=1, channel_mult="1,2", image_size=32,
                                   diffusion_steps=6, sample_schedule="sampled", **flags)
    model, diffusion = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    rng = np.random.default_rng(0)
    vols = {m: rng.random((1, 64, 64, 64, 1)).astype(np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :8] = 0.0
    return model, diffusion, common.prepare_condition(vols, "t1c", device="cuda"), vols["t1n"]


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm++"])
@pytest.mark.parametrize("flags", [dict(fuse_gn_silu=True), dict(fuse_conv=True)])
def test_graphed_chain_equals_the_eager_chain(gen, flags, sampler):
    """make_synthesis_fn on the card with cuda_graph=False and True, on one
    generator seed: the same image bit for bit, on the first graphed call
    (two warm-up steps, the capture, replays) and on the second (replays
    only), and for ddpm with chunk 4 (a ragged last segment); the same
    launches per volume on both paths, by wrapper and by kernel."""
    from fast_cwdm_tpu_torch import ops

    model, diffusion, cond, mask = _graph_case(flags)
    runs = {"eager": common.make_synthesis_fn(model, diffusion, crop_z=32, sampler=sampler,
                                              sampler_steps=4, device="cuda", cuda_graph=False),
            "graph": common.make_synthesis_fn(model, diffusion, crop_z=32, sampler=sampler,
                                              sampler_steps=4, device="cuda")}
    if sampler == "ddpm":
        runs["graph_chunk_4"] = common.make_synthesis_fn(model, diffusion, crop_z=32, chunk=4,
                                                         device="cuda")
    imgs, counts = {}, {}
    for name, run in runs.items():
        for k in range(2):
            ops.set_launch_counts(dict.fromkeys(ops.launch_counts(), 0))
            imgs[name, k] = run(cond, mask, torch.Generator(device="cuda").manual_seed(3))
            torch.cuda.synchronize()
            counts[name, k] = ops.launch_counts()
    assert runs["eager"].chain is None and runs["graph"].chain.graph.graph is not None
    ref = imgs["eager", 0]
    assert ref.shape == (1, 64, 64, 32) and ref.max() > 0.0
    for key, img in imgs.items():
        assert np.array_equal(img, ref), (key, float(np.abs(img - ref).max()))
        assert counts[key] == counts["eager", 0], (key, counts[key], counts["eager", 0])
    site = "conv3d_fused_k4b" if flags.get("fuse_conv") else "affine_silu"
    assert counts["eager", 0][site] > 0
    if flags.get("fuse_conv"):
        assert counts["eager", 0]["conv3d_wgmma"] > 0 and counts["eager", 0]["conv3d_splitk"] > 0


def test_unfused_projection_chain_runs_k2_and_k1_each_step(gen):
    """``fuse_clip_projection=False`` (the reference's IDWT → clamp → DWT
    every step) on the _graph_case UNet in fp32: one K2 and one K1 a step
    beside the output's K2 (the condition is made before), on both paths; the
    graphed image equals the eager one bit for bit, and the fused
    projection's within 1e-4."""
    from fast_cwdm_tpu_torch import ops

    model, diffusion, cond, mask = _graph_case(dict(dtype="float32"))
    steps = diffusion.num_timesteps
    imgs = {}
    for fuse in (False, True):
        for graphed in (False, True):
            run = common.make_synthesis_fn(
                model, diffusion.replace(fuse_clip_projection=fuse), crop_z=32, device="cuda",
                cuda_graph=graphed)
            ops.set_launch_counts(dict.fromkeys(ops.launch_counts(), 0))
            imgs[fuse, graphed] = run(cond, mask, torch.Generator(device="cuda").manual_seed(3))
            torch.cuda.synchronize()
            got = {k: ops.launch_counts()[k] for k in ("haar_dwt3", "haar_idwt3")}
            extra = 0 if fuse else steps
            assert got == {"haar_dwt3": extra, "haar_idwt3": 1 + extra}, (fuse, graphed, got)
    assert imgs[False, False].max() > 0.0
    assert np.array_equal(imgs[False, True], imgs[False, False])
    np.testing.assert_allclose(imgs[False, True], imgs[True, True], atol=1e-4)


def test_attention_unet_graphed_chain_equals_the_eager_chain(gen):
    """The _graph_case UNet with attention at ds 2 (16³ = 4,096 positions,
    4 heads) and in the bottleneck: the graphed chain's image equals the
    eager chain's bit for bit."""
    model, diffusion, cond, mask = _graph_case(dict(attention_resolutions="16",
                                                    bottleneck_attention=True, num_heads=4))
    assert sum(type(m).__name__ == "AttentionBlock" for m in model.modules()) == 4
    imgs = {}
    for graphed in (False, True):
        run = common.make_synthesis_fn(model, diffusion, crop_z=32, device="cuda",
                                       cuda_graph=graphed)
        imgs[graphed] = run(cond, mask, torch.Generator(device="cuda").manual_seed(3))
    assert imgs[False].max() > 0.0 and np.array_equal(imgs[True], imgs[False])


def test_wunet_forward_on_the_card_matches_the_cpu(gen):
    """A WavUNet (widths 16/32, two res blocks a level, attention at ds 2,
    the reference's double run) in fp32 on the card against the CPU, same
    seeded weights and input, TF32 off: within 1e-4."""
    from fast_cwdm_tpu_torch.models.wunet import WavUNetModel

    cfg = dict(image_size=16, in_channels=32, model_channels=16, out_channels=8,
               num_res_blocks=2, attention_resolutions=(2,), channel_mult=(1, 2), num_groups=8,
               resample_2d=False, num_heads=2, ref_compat=True)
    model = WavUNetModel(**cfg).eval()
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = torch.randn((1, 32, 16, 16, 12), generator=torch.Generator().manual_seed(0))
    t = torch.tensor([123])
    with torch.no_grad():
        ref = model(x, t)
        ours = model.cuda()(x.cuda(), t.cuda())
    torch.cuda.synchronize()
    assert ours.shape == ref.shape == (1, 8, 16, 16, 12)
    torch.testing.assert_close(ours.cpu(), ref, atol=1e-4, rtol=0)


def test_a_failed_capture_raises(gen):
    """A step that copies from host memory cannot be captured: the graphed
    chain raises at the capture (after the two eager warm-up steps) and
    returns nothing, and it does not run the eager loop instead."""
    model, diffusion, cond, mask = _graph_case(dict(fuse_gn_silu=True))

    class HostCopy(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, t):
            return self.inner(x, t) + torch.from_numpy(np.zeros(1, np.float32)).to(x.device)

    run = common.make_synthesis_fn(HostCopy(model), diffusion, crop_z=32, device="cuda")
    with pytest.raises(RuntimeError):
        run(cond, mask, torch.Generator(device="cuda").manual_seed(0))
    assert run.chain.graph.warmups == 2 and run.chain.graph.graph is None


def test_ssim3d_and_psnr_on_the_card_match_the_cpu(gen, tmp_path):
    """The evaluation metrics compute in float64 on the device of their
    inputs; the card agrees with the CPU, and evaluate_cases too."""
    from fast_cwdm_tpu_torch.cli import evaluate_synthesis as ev

    a = torch.rand((40, 36, 30), generator=gen, device="cuda", dtype=torch.float64)
    b = (a + 0.1 * torch.randn(a.shape, generator=gen, device="cuda", dtype=torch.float64)).clamp(0, 1)
    for win in (3, 7, 9):
        assert abs(ev.ssim3d(a, b, win=win) - ev.ssim3d(a.cpu(), b.cpu(), win=win)) <= 1e-12
    assert abs(ev.psnr(a, b) - ev.psnr(a.cpu(), b.cpu())) <= 1e-10
    assert abs(ev.ssim3d(a.float(), b.float()) - ev.ssim3d(a.float().cpu(), b.float().cpu())) <= 1e-12
    for i in range(2):
        d = tmp_path / f"case{i}"
        d.mkdir()
        for name, v in (("sample", b), ("target", a)):
            nifti.save(nifti.Nifti1Image((v + 0.01 * i).float().cpu().numpy(), np.eye(4)),
                       str(d / f"{name}.nii.gz"))
    card, cpu = ev.evaluate_cases(str(tmp_path), device="cuda"), ev.evaluate_cases(str(tmp_path),
                                                                                  device="cpu")
    assert card["n"] == cpu["n"] == 2
    for r, c in zip(card["cases"], cpu["cases"]):
        assert r["case"] == c["case"]
        for k in ("ssim", "psnr", "mse"):
            assert abs(r[k] - c[k]) <= 1e-10, (k, r, c)


class _matmul_fp32:
    """cuBLAS without TF32 inside the block, the flag restored after it."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def test_diffusion_api_on_the_card_matches_the_cpu(gen):
    """sample_known, the DDIM known loop, a ddim_reverse_sample step and
    calc_bpd_loop of the tiny fp32 UNet (fuse_gn_silu) on the card and on
    the CPU, on the same draws, TF32 off: within 1e-4 (the bound's bits
    relative to their scale)."""
    cfg = _tiny_cfg(fuse_gn_silu=True)
    rng = np.random.default_rng(1)
    shape = (1, 8, 8, 8, 8)
    draw = lambda: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    img = torch.from_numpy(rng.random(shape).astype(np.float32))
    cond = torch.from_numpy(rng.random((1, 8, 8, 8, 24)).astype(np.float32))
    x_known, steps, x_ddim, bpd_noise = draw(), [draw() for _ in range(4)], draw(), \
        [draw() for _ in range(4)]
    out = {}
    for dev in ("cpu", "cuda"):
        model, diffusion = common.build_model_and_diffusion(cfg)
        sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(dev).eval()

        def fn(x, t):
            return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)

        mv = lambda v: v.to(dev)  # noqa: E731
        with torch.inference_mode(), _matmul_fp32():
            out[dev] = {
                "known": diffusion.sample_known(fn, mv(img), cond=mv(cond), noise=mv(x_known),
                                                step_noise=[mv(s) for s in steps]),
                "ddim_known": diffusion.ddim_sample_loop_known(fn, shape, img=mv(cond),
                                                               noise=mv(x_ddim))[0],
                "reverse": diffusion.ddim_reverse_sample(
                    fn, mv(img), torch.tensor([2], device=dev), cond=mv(cond))["sample"],
                **{f"bpd.{k}": v for k, v in diffusion.calc_bpd_loop(
                    lambda x, t: x[..., :8] + 1e-3 * fn(x, t), mv(img), cond=mv(cond),
                    clip_denoised=False, step_noise=[mv(s) for s in bpd_noise]).items()}}
    for k, v in out["cpu"].items():
        scale = max(1.0, float(v.abs().max())) if k.startswith("bpd.") else 1.0
        torch.testing.assert_close(out["cuda"][k].cpu(), v, atol=1e-4 * scale, rtol=0)


_GLOO_CARD_CHILD = r"""
import json, os, sys
import numpy as np, torch
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.parallel import mesh as pm
from fast_cwdm_tpu_torch.training import state as tstate, train
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
dev = pm.setup_distributed("cuda")
mesh = pm.make_mesh()
cfg = json.loads(sys.argv[1])
model, _ = common.build_model_and_diffusion(cfg)
sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
model.to(dev)
data = np.load(sys.argv[2])
diffusion = GaussianDiffusion.named("linear", 4, "sampled", mode="i2i")
opt = train.make_optimizer(1e-4, eps=1e-3)
step = train.make_train_step(model, diffusion, opt, contr="t1n", mode="i2i", mesh=mesh)
state = tstate.TrainState.create(model, opt)
batch = pm.shard_batch(mesh, {m: data[m] for m in ("t1n", "t1c", "t2w", "t2f")}, device=dev)
state, m = step(state, batch, t=torch.from_numpy(data["t"]).to(dev),
                noise_img=torch.from_numpy(data["noise"]).to(dev))
np.savez(sys.argv[3] + f"{mesh.rank}.npz", loss=m["loss"].cpu().numpy(),
         **{k: v.detach().cpu().numpy() for k, v in state.params.items()})
print("RESULT " + json.dumps({"rank": mesh.rank, "device": str(dev)}), flush=True)
torch.distributed.destroy_process_group()
"""


def test_two_gloo_ranks_on_the_card_match_one_process(gen, tmp_path):
    """Two gloo ranks sharing the card (NCCL takes one rank per GPU), one
    fp32 train step of the tiny UNet (fuse_gn_silu) on global batch 2,
    against one process on the card: loss within 2e-5, parameters the
    same bits on both ranks and within 5e-3·lr plus two ulps of one
    process's."""
    import json

    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from fast_cwdm_tpu_torch.parallel import dryrun
    from fast_cwdm_tpu_torch.training import state as tstate
    from fast_cwdm_tpu_torch.training import train

    cfg = _tiny_cfg(fuse_gn_silu=True)
    rng = np.random.default_rng(0)
    data = {m: rng.random((2, 8, 8, 8, 1)).astype(np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
    data.update(noise=rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32),
                t=np.array([3, 1]))
    np.savez(tmp_path / "data.npz", **data)
    script = tmp_path / "child.py"
    script.write_text(_GLOO_CARD_CHILD)
    env = dict(os.environ, FAST_CWDM_DIST_BACKEND="gloo")
    recs = dryrun.results(dryrun.wait_ranks(dryrun.start_ranks(
        2, [str(script), json.dumps(cfg), str(tmp_path / "data.npz"), str(tmp_path / "rank")],
        env=env), 120))
    assert [r["device"] for r in recs] == ["cuda:0", "cuda:0"]
    model, _ = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.cuda()
    opt = train.make_optimizer(1e-4, eps=1e-3)
    step = train.make_train_step(model, GaussianDiffusion.named("linear", 4, "sampled", mode="i2i"),
                                 opt, contr="t1n", mode="i2i")
    state = tstate.TrainState.create(model, opt)
    with _matmul_fp32():
        state, m = step(state, {k: torch.from_numpy(data[k]).cuda()
                                for k in ("t1n", "t1c", "t2w", "t2f")},
                        t=torch.from_numpy(data["t"]).cuda(),
                        noise_img=torch.from_numpy(data["noise"]).cuda())
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert abs(float(ranks[0]["loss"]) - float(m["loss"])) <= 2e-5
    for k, p in state.params.items():
        v = p.detach().cpu().numpy()
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
        assert (np.abs(ranks[0][k] - v) <= 5e-3 * 1e-4 + 2.0**-22 * np.abs(v)).all(), k
