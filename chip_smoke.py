#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (what a release check runs)
    python3 chip_smoke.py --profile  # also trace one forward and one train step of each kind

Phases, each printing one JSON object per line:

1. device   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build    — compile the hand-written kernels (``ops/csrc/*.cu``) with nvcc;
3. kernels  — each kernel against its plain PyTorch version at the shapes
              of the production path, with its time, the plain version's,
              one library call's where one computes the same function, and
              the least time the card could take (bytes or operations);
              the fused conv (K4a/K4b/K5) on each of its kernels that
              takes the shape (wgmma, split-K, mma.sync) at nine shapes,
              with the tolerance ratio (≤ 1 passes), differing elements
              and two launches bit for bit, and the three kernels, cuDNN
              and the bound at every distinct conv shape of the forward;
4. forward  — the 81,511,048-parameter production UNet in bf16 at
              (1, 112, 112, 80, 32): unfused, fuse_gn_silu (K3) and
              fuse_conv (K4b), timed in turns; with ``--profile`` the
              device time by kernel;
5. synthesis— the ``fast_cwdm_tpu_torch.cli.sample`` entry point on one
              synthetic 240×240×155 BraTS case with seeded weights, 10-step
              sampled schedule, twice: every GN→SiLU through K3 (ddpm),
              then every ResBlock conv through K4b (dpm++, 10 evaluations,
              as ``bench.py --fused --dpm 10``); the launch counts of each
              run, by entry point and by kernel (levels 0-2 on wgmma,
              3-4 on split-K, by ``conv3d_cuda.route``), and that each
              went through the captured CUDA graph chain (one capture,
              eight replays); then ``make_synthesis_fn`` of four variants,
              each eager (``cuda_graph=False``) and graphed, in turns: the
              images of the two paths (bit for bit expected), launches per
              volume, capture seconds and graph pool memory; a ``devtime``
              trace of the fuse_conv dpm++ synthesis on each path (device
              ms, wall ms, busy share); a 100-step fuse_conv ddpm chain,
              graphed, with ``chunk`` None and 32, equal bit for bit;
6. completion— the production weights written as a JAX-layout ``.ckpt``
              (with one EMA shadow and a sidecar as the JAX package writes
              it) and read back bit for bit, its size and seconds; then
              ``fast_cwdm_tpu_torch.cli.complete_dataset`` on two
              240×240×155 cases without t1c and one complete case: (a) the
              sidecar as written (unfused ddpm: 3 K1 + 1 K2 per case), (b)
              ``fuse_conv`` added to the sidecar with ``--sampler dpm++
              --sampling_steps 10`` (540 K4b per case: 300 wgmma, 240
              split-K); then ``cli.sample_auto`` on the same tree; every
              output checked (geometry, affine, [0,1], brain mask, border,
              pass-through), each run through the captured chain, and the
              seconds per case;
7. training — the K3 VJP kernel against its plain version at every
              distinct GN+SiLU shape of the production UNet (bf16
              channels_last_3d and fp32 contiguous; gx bit for bit, ga and
              gb within 1e-5 of the sum of the terms' magnitudes, two
              launches bit for bit), its time per shape and per train step;
              then ``fast_cwdm_tpu_torch.cli.train`` with ``run.sh``'s TRAIN
              flags (batch 1, lr 1e-5, use_checkpoint) on two synthetic
              240×240×155 cases at the production config, a few steps each
              and a BEST: (a) unfused, (b) ``--fuse_gn_silu=True`` (K3 and
              its VJP); warm s/step, peak memory, the loss of every step,
              parameters moved, launches per step; (a) again without
              use_checkpoint for its peak memory; a fuse_conv model under
              backward still raises; then ``cli.complete_dataset`` from (a)'s
              BEST on a case without t1c, output checked;
8. reference— the whole synthesis at a tiny fp32 config on the card,
              graphed and eager, against the same on the CPU (plain
              versions), same noise: fuse_gn_silu under ddpm, and
              fuse_conv under ddpm, ddim and dpm++;
9. evaluation— the BraSyn evaluation chain at full size through the
              port's entry points: ``scripts.quality_bench`` stage gen (2
              train and 4 val 240×240×155 phantoms), ``run.sh --mode
              train`` (4 steps: K1 5, K2 1 per step), stage eval (copy
              rows equal to QUALITY_r04.json's within 1e-9; a 4-step
              model's rows, finite), ``cli.drop_modality``, ``run.sh
              --mode complete`` as written (3 K1 + 1 K2 per case) and with
              fuse_conv + dpm++ 10 (540 K4b per case: 300 wgmma, 240
              split-K), ``cli.prepare_nnunet_dataset``, ``run.sh --mode
              sample`` + ``cli.evaluate_synthesis`` on the card,
              ``scripts.downstream_bench`` (real leg and GT region means
              equal to the JAX records within 1e-12), and ``ssim3d`` /
              ``psnr`` on the card against the CPU (≤ 1e-10) with both
              times.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and, last,
``{"ok": true, "device": {...}}``. Any failed phase exits nonzero before
the last line. Exits nonzero without a result when no CUDA device is
present or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor cores
VOLUME = (224, 224, 160)
LATENT = (112, 112, 80)
# (channels, spatial) of the production UNet's levels where GN→SiLU runs
K3_SHAPES = ((64, (112, 112, 80)), (128, (56, 56, 40)), (256, (14, 14, 10)))
# (label, B, Ci, (X, Y, Z), Co) of the fused ResBlock convs checked against
# the plain version, bf16
CONV_SHAPES = (
    ("level 0", 1, 64, (112, 112, 80), 64),
    ("level 0 decoder concat", 1, 128, (112, 112, 80), 64),
    ("level 0 decoder concat 192", 1, 192, (112, 112, 80), 64),
    ("level 1", 1, 128, (56, 56, 40), 128),
    ("level 3", 1, 256, (14, 14, 10), 256),
    ("level 4, 7×7×5", 1, 256, (7, 7, 5), 256),
    ("level 4 decoder concat, X = 7", 1, 512, (7, 7, 5), 256),
    ("B = 2, per-(B, C) statistics", 2, 128, (28, 28, 20), 128),
    ("Ci = 8 mod 16", 1, 24, (20, 20, 12), 64),
)
CONV_TOL = "1 ulp of plain in the output dtype + 2^-16 conv(|act|, |w|)"
# ((X, Y, Z), Ci, Co): launches per forward) of every fused conv of the
# production UNet with fuse_conv (54 per forward)
PRODUCTION_CONVS = {
    ((112, 112, 80), 64, 64): 7, ((112, 112, 80), 128, 64): 2, ((112, 112, 80), 192, 64): 1,
    ((56, 56, 40), 64, 128): 1, ((56, 56, 40), 128, 128): 6, ((56, 56, 40), 192, 128): 1,
    ((56, 56, 40), 256, 128): 2,
    ((28, 28, 20), 128, 128): 7, ((28, 28, 20), 256, 128): 2, ((28, 28, 20), 384, 128): 1,
    ((14, 14, 10), 128, 256): 1, ((14, 14, 10), 256, 256): 6, ((14, 14, 10), 384, 256): 1,
    ((14, 14, 10), 512, 256): 2,
    ((7, 7, 5), 256, 256): 11, ((7, 7, 5), 512, 256): 3,
}


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 25) -> float:
    """Median of ``reps`` single launches timed with CUDA events, the L2
    cache flushed before each (the synthesis path finds its inputs cold).
    The card spins for about a millisecond before each start event, so the
    wrapper's host work is enqueued behind it and the events time the
    kernels alone, not the host's launch overhead."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k3_tol_ratio(torch, ours, ref, x, a, b) -> float:
    """max |ours − ref| over K3's elementwise tolerance: one bf16 ulp of
    ``ref`` (a rounding flip of the final cast) plus 2^-20·(|x·a| + |b|)
    (a few fp32 ulps of the argument u = x·a + b, should the two sides
    round u differently; silu' ≤ 1.1). ≤ 1 passes."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    bc = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    scale = (x.float() * a.reshape(bc)).abs() + b.reshape(bc).abs()
    return float(((ours.float() - ref).abs() / (ulp + 2.0**-20 * scale)).max())


def phase_kernels(torch, F) -> dict:
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import wavelet as wv
    from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

    torch.backends.cudnn.allow_tf32 = False  # fp32 library yardsticks in fp32
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    # Haar filters of the 8 bands as one stride-2 convolution (the library
    # call computing the same function as K1; its transpose computes K2)
    w = torch.as_tensor(wv._haar_mixing_matrix(), dtype=torch.float32, device="cuda")
    w = w.reshape(8, 1, 2, 2, 2)

    x = torch.rand((1, *VOLUME), generator=g, device="cuda")
    y = wc.haar_dwt3(x)
    err = float((y - wc.haar_dwt3_plain(x)).abs().max())
    lib = F.conv3d(x[:, None], w, stride=2).permute(0, 2, 3, 4, 1)
    nb = 2 * x.numel() * 4
    b_ms, b_by = bound_ms(nb, 6 * x.numel())
    out["haar_dwt3"] = dict(
        shape=list(x.shape), max_abs_err=err, tol=1e-5,
        library_max_abs_err=float((lib - y).abs().max()),
        ms=time_ms(torch, lambda: wc.haar_dwt3(x)),
        plain_ms=time_ms(torch, lambda: wc.haar_dwt3_plain(x)),
        library_ms=time_ms(torch, lambda: F.conv3d(x[:, None], w, stride=2)),
        bound_ms=b_ms, bound_by=b_by, bytes=nb,
    )

    yb = torch.randn((1, *LATENT, 8), generator=g, device="cuda")
    xi = wc.haar_idwt3(yb)
    err = float((xi - wc.haar_idwt3_plain(yb)).abs().max())
    yb_ncdhw = yb.permute(0, 4, 1, 2, 3)
    lib = F.conv_transpose3d(yb_ncdhw, w, stride=2)[:, 0]
    b_ms, b_by = bound_ms(nb, 6 * xi.numel())
    out["haar_idwt3"] = dict(
        shape=list(yb.shape), max_abs_err=err, tol=1e-5,
        library_max_abs_err=float((lib - xi).abs().max()),
        ms=time_ms(torch, lambda: wc.haar_idwt3(yb)),
        plain_ms=time_ms(torch, lambda: wc.haar_idwt3_plain(yb)),
        library_ms=time_ms(torch, lambda: F.conv_transpose3d(yb_ncdhw, w, stride=2)),
        bound_ms=b_ms, bound_by=b_by, bytes=nb,
    )
    torch.backends.cudnn.allow_tf32 = True

    # K3: bf16 at each level width, B = 1 and 2, both memory formats, held
    # to the elementwise tolerance of k3_tol_ratio. Kernel and plain version
    # run the same fp32 operations in the same order, so the expected
    # disagreement is none; the count of differing elements is printed.
    checks, worst_err, worst_ratio = [], 0.0, 0.0
    for c, sp in K3_SHAPES:
        for bsz in (1, 2):
            xs = torch.randn((bsz, *sp, c), generator=g, device="cuda").to(torch.bfloat16)
            a = torch.randn((bsz, c), generator=g, device="cuda")
            b = torch.randn((bsz, c), generator=g, device="cuda")
            for fmt, t in (("channels_last_3d", xs.permute(0, 4, 1, 2, 3)),
                           ("contiguous", xs.permute(0, 4, 1, 2, 3).contiguous())):
                ours, ref = ec.affine_silu(t, a, b), ec.affine_silu_plain(t, a, b)
                if ours.stride() != t.stride():
                    fail(f"K3 changed the memory format ({fmt})")
                ratio = k3_tol_ratio(torch, ours, ref, t, a, b)
                err = float((ours.float() - ref.float()).abs().max())
                checks.append(dict(c=c, spatial=list(sp), batch=bsz, format=fmt,
                                   max_abs_err=err, tol_ratio=ratio,
                                   n_differ=int((ours != ref).sum())))
                worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio)
    c, sp = K3_SHAPES[0]
    xs = torch.randn((1, *sp, c), generator=g, device="cuda").to(torch.bfloat16)
    t = xs.permute(0, 4, 1, 2, 3)
    a = torch.randn((1, c), generator=g, device="cuda")
    b = torch.randn((1, c), generator=g, device="cuda")
    nb = 2 * t.numel() * 2 + 2 * a.numel() * 4
    b_ms, b_by = bound_ms(nb, 6 * t.numel())
    out["affine_silu"] = dict(
        shape=list(t.shape), dtype="bfloat16", max_abs_err=worst_err,
        tol_ratio=worst_ratio, tol="1 bf16 ulp of y + 2^-20 (|x a| + |b|)", checks=checks,
        ms=time_ms(torch, lambda: ec.affine_silu(t, a, b)),
        plain_ms=time_ms(torch, lambda: ec.affine_silu_plain(t, a, b)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nb,
    )
    for name in ("haar_dwt3", "haar_idwt3"):
        if not out[name]["max_abs_err"] <= 1e-5:
            fail(f"{name} disagrees with its plain version: {out[name]['max_abs_err']}")
    if not worst_ratio <= 1.0:
        fail(f"affine_silu disagrees with its plain version: {checks}")
    return out


def conv_inputs(torch, g, bsz, ci, sp, co, dtype):
    """x (channels_last_3d), w (3,3,3,Ci,Co), b, and GN statistics of x
    with a nonzero bias (pro(0) != 0 tests the zero padding)."""
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

    x = torch.randn((bsz, *sp, ci), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
    w = torch.randn((3, 3, 3, ci, co), generator=g, device="cuda") * (27 * ci) ** -0.5
    b = 0.02 * torch.randn(co, generator=g, device="cuda")
    mean, inv = tc.group_stats(x, math.gcd(ci, 32))
    scale = 1.0 + 0.05 * torch.randn(ci, generator=g, device="cuda")
    bias = 0.3 + 0.05 * torch.randn(ci, generator=g, device="cuda")
    return x, w, b, (mean, inv, scale, bias)


def conv_cost(x, co, extra_out: int = 0) -> tuple[int, int]:
    """(bytes, flops) of one fused conv: x, w and the output (and skip)
    once each; 2·voxels·Co·27·Ci operations."""
    ci = x.shape[1]
    vox = x.numel() // ci
    esize = x.element_size()
    n_bytes = (x.numel() + 27 * ci * co + (1 + extra_out) * vox * co) * esize
    return n_bytes, 2 * vox * co * 27 * ci


def phase_conv(torch, F) -> dict:
    """The fused conv behind K4a, K4b and K5, the three hand-written
    kernels against the plain version: the wgmma kernel
    (``conv3d_wgmma.cu``) and the split-K kernel (``conv3d_splitk.cu``),
    both bf16 with Ci % 16 == 0 and Co % 64 == 0 (split-K where its halo
    fits), and the mma.sync kernel (``conv3d.cu``), at every shape of
    CONV_SHAPES each takes (K4b with the GN prologue and without, K4a with
    fold_taps both ways, K5 with temb and skip; the routed kernel through
    each entry point, and twice, bit for bit) and the level-1 shape in
    fp32 (mma.sync only). Then, at every distinct conv shape of the
    production forward, the time of each kernel with the prologue, of
    cuDNN (``F.conv3d`` bf16 channels_last_3d, the conv alone) and the
    bound, beside the kernel ``route`` picks and the split-K plan; the
    fp32 level-1 and the B = 2 shapes on their routed kernel; and at level
    0 each entry point through the routed kernel."""
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

    g = torch.Generator(device="cuda").manual_seed(2)
    checks, worst = [], {"k4a": [0.0, 0.0], "k4b": [0.0, 0.0], "k5": [0.0, 0.0]}

    def check(entry, label, kernel, y, ref, x, w, gn, **info):
        ratio = tc.tol_ratio(y, ref, x, w, gn)
        err = float((y.float() - ref.float()).abs().max())
        checks.append(dict(entry=entry, kernel=kernel, shape=label, x=list(x.shape),
                           co=w.shape[-1], dtype=str(x.dtype).split(".")[-1], max_abs_err=err,
                           tol_ratio=ratio, n_differ=int((y != ref).sum()), **info))
        worst[entry] = [max(worst[entry][0], err), max(worst[entry][1], ratio)]

    shapes = [(lab, b, ci, sp, co, torch.bfloat16) for lab, b, ci, sp, co in CONV_SHAPES]
    shapes.append(("level 1, fp32", 1, 128, (56, 56, 40), 128, torch.float32))
    for label, bsz, ci, sp, co, dtype in shapes:
        x, w, b, gn = conv_inputs(torch, g, bsz, ci, sp, co, dtype)
        temb = torch.randn((bsz, co), generator=g, device="cuda")
        skip = torch.randn((bsz, *sp, co), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
        ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
        ref_np = tc.conv3d_fused_plain(x, w, b)
        ref_v4 = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
        # the entry points, on the kernel route() picks
        routed = tc.route(dtype, bsz, ci, co, *sp)
        wp = tc.pack_wgmma_weights(w) if routed in ("wgmma", "splitk") else None
        y = tc.conv3d_fused(x, w, b, gn=gn, block_x=2, w_packed=wp)
        again = tc.conv3d_fused(x, w, b, gn=gn, block_x=2, w_packed=wp)
        check("k4b", label, routed, y, ref, x, w, gn, prologue=True,
              bit_identical_twice=bool(torch.equal(y, again)))
        del y, again
        if dtype == torch.float32:
            continue
        for fold in (True, False):
            check("k4a", label, routed, tc.conv3d_fused(x, w, b, gn=gn, fold_taps=fold, w_packed=wp),
                  ref, x, w, gn, prologue=True, fold_taps=fold)
        check("k4b", label, routed, tc.conv3d_fused(x, w, b, block_x=2, w_packed=wp), ref_np,
              x, w, None, prologue=False)
        check("k5", label, routed,
              tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip, w_packed=wp), ref_v4, x, w,
              gn, prologue=True, temb=True, skip=True)
        # the other kernels, where they take the shape
        for other in takers(tc, torch, bsz, ci, co, sp):
            if other == routed:
                continue
            for entry, (g_, t_, s_, r_) in {"k4b": (gn, None, None, ref),
                                            "k4b_np": (None, None, None, ref_np),
                                            "k5": (gn, temb, skip, ref_v4)}.items():
                check(entry[:3], label, other, tc._launch(entry, x, w, b, g_, t_, s_, kernel=other),
                      r_, x, w, g_, prologue=g_ is not None, temb=t_ is not None,
                      skip=s_ is not None)
        del x, w, gn, temb, skip, ref, ref_np, ref_v4
    torch.cuda.empty_cache()

    # every distinct production conv shape: the three kernels with the
    # prologue (split-K where its halo fits), cuDNN's conv alone, the bound,
    # the route and the split-K plan
    timings = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for (sp, ci, co), per_forward in PRODUCTION_CONVS.items():
        x, w, b, gn = conv_inputs(torch, g, 1, ci, sp, co, torch.bfloat16)
        wp = tc.pack_wgmma_weights(w)
        w_lib = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        b_lib = b.to(torch.bfloat16)
        nb, fl = conv_cost(x, co)
        b_ms, b_by = bound_ms(nb, fl, PEAK_BF16_FLOPS)
        plan = tc.splitk_plan(1, ci, co, *sp, n_sm)
        ms = {k: (time_ms(torch, lambda: tc._launch("k4b", x, w, b, gn, None, None, wp, k), reps=10)
                  if k in takers(tc, torch, 1, ci, co, sp) else None)
              for k in ("wgmma", "splitk", "mma_sync")}
        routed = tc.route(x.dtype, 1, ci, co, *sp)
        if routed == "splitk":  # the prologue's share of the split-K kernel
            ms["splitk_no_prologue"] = time_ms(
                torch, lambda: tc._launch("k4b", x, w, b, None, None, None, wp, "splitk"), reps=10)
        timings.append(dict(
            x=list(x.shape), co=co, per_forward=per_forward, route=routed,
            wgmma_ms=ms["wgmma"], splitk_ms=ms["splitk"], mma_sync_ms=ms["mma_sync"],
            splitk_no_prologue_ms=ms.get("splitk_no_prologue"),
            cudnn_ms=time_ms(torch, lambda: F.conv3d(x, w_lib, b_lib, padding=1), reps=10),
            bound_ms=b_ms, bound_by=b_by, gflop=fl / 1e9, mbytes=nb / 1e6,
            splitk_plan=dict(bm=plan["bm"], S=plan["S"], grid=plan["grid"],
                             ctas=plan["ctas"],
                             workspace_mb=plan["workspace_bytes"] / 1e6,
                             smem_bytes=plan["smem_bytes"], fits=plan["fits"])))
        del x, w, wp, gn, w_lib
    # the fp32 level-1 conv and the B = 2 conv of CONV_SHAPES, with the
    # prologue, on the kernel route() picks
    other_timings = []
    b2 = next(shape for shape in shapes if shape[1] == 2)
    for label, bsz, ci, sp, co, dtype in (shapes[-1], b2):
        x, w, b, gn = conv_inputs(torch, g, bsz, ci, sp, co, dtype)
        nb, fl = conv_cost(x, co)
        b_ms, b_by = bound_ms(nb, fl, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else
                              PEAK_FP32_FLOPS)
        other_timings.append(dict(
            shape=label, x=list(x.shape), co=co, dtype=str(dtype).split(".")[-1],
            route=tc.route(dtype, bsz, ci, co, *sp),
            ms=time_ms(torch, lambda: tc.conv3d_fused(x, w, b, gn=gn, block_x=2), reps=10),
            bound_ms=b_ms, bound_by=b_by))
        del x, w, gn
    torch.cuda.empty_cache()

    # level 0, 64 → 64: each entry point through the routed kernel, its
    # plain version, cuDNN; the wgmma kernel without the prologue (cuDNN's
    # function); the mma.sync kernel
    x, w, b, gn = conv_inputs(torch, g, *CONV_SHAPES[0][1:], torch.bfloat16)
    co = w.shape[-1]
    wp = tc.pack_wgmma_weights(w)
    temb = torch.randn((1, co), generator=g, device="cuda")
    skip = torch.randn((1, *CONV_SHAPES[0][3], co), generator=g, device="cuda")
    skip = skip.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    w_lib = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    b_lib = b.to(torch.bfloat16)
    lib_ms = time_ms(torch, lambda: F.conv3d(x, w_lib, b_lib, padding=1))
    runs = {  # the entry point; the mma.sync kernel on the same call; the plain version
        "k4b": (lambda: tc.conv3d_fused(x, w, b, gn=gn, block_x=2, w_packed=wp),
                lambda: tc._launch("k4b", x, w, b, gn, None, None, kernel="mma_sync"),
                lambda: tc.conv3d_fused_plain(x, w, b, gn=gn), 0),
        "k4a": (lambda: tc.conv3d_fused(x, w, b, gn=gn, w_packed=wp),
                lambda: tc._launch("k4a", x, w, b, gn, None, None, kernel="mma_sync"),
                lambda: tc.conv3d_fused_plain(x, w, b, gn=gn), 0),
        "k5": (lambda: tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip, w_packed=wp),
               lambda: tc._launch("k5", x, w, b, gn, temb, skip, kernel="mma_sync"),
               lambda: tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip), 1),
    }
    routed = tc.route(x.dtype, *x.shape[:2], co, *x.shape[2:])
    out = {}
    for entry, (kern, mma_sync, plain, extra) in runs.items():
        nb, fl = conv_cost(x, co, extra)
        b_ms, b_by = bound_ms(nb, fl, PEAK_BF16_FLOPS)
        out[entry] = dict(
            shape=list(x.shape), co=co, dtype="bfloat16", kernel=routed,
            max_abs_err=worst[entry][0], tol_ratio=worst[entry][1], tol=CONV_TOL,
            ms=time_ms(torch, kern), mma_sync_ms=time_ms(torch, mma_sync),
            plain_ms=time_ms(torch, plain, reps=5), library_ms=lib_ms,
            library="F.conv3d bf16 channels_last_3d (cuDNN), the conv alone, no prologue"
                    + (" or temb/skip" if extra else ""),
            bound_ms=b_ms, bound_by=b_by, bytes=nb, flops=fl,
        )
    out["level0_wgmma_no_prologue_ms"] = time_ms(
        torch, lambda: tc._launch("no prologue", x, w, b, None, None, None, wp, "wgmma"))
    out["level0_mma_sync_no_prologue_ms"] = time_ms(
        torch, lambda: tc._launch("no prologue", x, w, b, None, None, None, kernel="mma_sync"))
    out["checks"], out["timings"], out["other_timings"] = checks, timings, other_timings
    # launch-weighted ms per forward of each kernel over the shapes route()
    # gives it, beside cuDNN's and the bound's over the same shapes
    out["by_route"] = {
        k: {f"{key}_per_forward": sum(r[key] * r["per_forward"] for r in timings
                                      if r["route"] == k)
            for key in (f"{k}_ms", "cudnn_ms", "bound_ms")}
        | {"launches_per_forward": sum(r["per_forward"] for r in timings if r["route"] == k)}
        for k in ("wgmma", "splitk", "mma_sync")}
    deep = next(r for r in timings if r["x"][2:] == [7, 7, 5] and r["x"][1] == 256)
    out["deep_levels"] = dict(out["by_route"]["splitk"], shape_7x7x5_256to256={
        key: deep[key] for key in ("splitk_ms", "splitk_no_prologue_ms", "wgmma_ms", "mma_sync_ms", "cudnn_ms",
                                   "bound_ms", "bound_by", "splitk_plan")})
    bad = [c for c in checks if not c["tol_ratio"] <= 1.0
           or not c.get("bit_identical_twice", True)]
    if bad:
        fail(f"the fused conv disagrees with its plain version or itself: {bad}")
    # the wgmma kernel's prologue divides by its own branch-free reciprocal
    out["wgmma_recip_mismatches_of_2_126_range"] = tc.recip_mismatches()
    if out["wgmma_recip_mismatches_of_2_126_range"]:
        fail("the wgmma kernel's reciprocal differs from IEEE 1/d on [1, 2^126)")
    return out


def takers(tc, torch, bsz, ci, co, sp) -> list:
    """The conv kernels that take this bf16 shape."""
    out = ["mma_sync"]
    if ci % tc.WG_BK == 0 and co % tc.WG_BN == 0:
        out.append("wgmma")
        if tc.splitk_plan(bsz, ci, co, *sp, 1)["fits"]:
            out.append("splitk")
    return out


def seeded_production(torch, **overrides) -> tuple[dict, dict]:
    """The production config and its seeded weights (a torch state_dict),
    checked to be the 81,511,048-parameter model."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    cfg = common.production_config(sample_schedule="sampled", diffusion_steps=10, **overrides)
    model, _ = common.build_model_and_diffusion(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(shapes).items()}
    n = sum(v.numel() for v in sd.values())
    if n != 81_511_048:
        fail(f"production UNet has {n} parameters, expected 81,511,048")
    return cfg, sd


def profile_device(torch, fn) -> dict:
    """Device time of one call of ``fn`` by kernel (``utils.devtime``, after
    one warm call): the total, the busy share of the host-clock wall time,
    sums by kind, and the top kernels."""
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    res = devtime(fn, iters=1, detail=True)
    kinds = (("K3 VJP affine_silu_bwd", ("affine_silu_bwd",)),
             ("K3 affine_silu", ("affine_silu",)),
             ("K4b fused conv3d, wgmma", ("conv3d_wgmma",)),
             ("K4b fused conv3d, split-K", ("conv3d_splitk_kernel",)),
             ("K4b fused conv3d, split-K reduction", ("conv3d_splitk_reduce",)),
             ("K4b fused conv3d, mma.sync", ("conv3d_bf16", "conv3d_f32")),
             ("convolution backward (cuDNN dgrad, wgrad)", ("dgrad", "wgrad")),
             ("convolution", ("conv", "xmma", "cudnn", "fprop", "implicit", "gemm")),
             ("optimizer and EMA (foreach)", ("foreach", "multi_tensor")),
             ("reduction (GroupNorm statistics)", ("reduce",)),
             ("elementwise and copies", ("elementwise", "copy", "cat", "upsample",
                                         "avg_pool", "index")))
    sums = {}
    for name, ms in res["ops"].items():
        kind = next((k for k, keys in kinds if any(w in name.lower() for w in keys)), "other")
        sums[kind] = sums.get(kind, 0.0) + ms
    return {"wall_ms": res["wall_ms"], "device_ms": res["total_ms"],
            "busy_share": res["busy_share"],
            "by_kind_ms": dict(sorted(sums.items(), key=lambda kv: -kv[1])),
            "top_kernels": [dict(ms=ms, name=k[:90]) for k, ms in list(res["ops"].items())[:12]]}


FORWARD_VARIANTS = {"unfused": {}, "fused": dict(fuse_gn_silu=True),
                    "fuse_conv": dict(fuse_conv=True)}


def phase_forward(torch, profile: bool = False) -> dict:
    """The production forward unfused, with fuse_gn_silu (K3) and with
    fuse_conv (K4b), timed in turns (u, f, c, c, f, u; two rounds; host
    clock around a synchronised forward), and the fp32 forward as the
    yardstick of bf16's own error."""
    from fast_cwdm_tpu_torch.cli import common

    cfg, sd = seeded_production(torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, *LATENT, 32), generator=g, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([9], device="cuda")
    models = {}
    for name, flags in FORWARD_VARIANTS.items():
        m, _ = common.build_model_and_diffusion(dict(cfg, **flags))
        m.load_state_dict(sd)
        models[name] = m.cuda().eval()
    times = {name: [] for name in models}
    with torch.inference_mode():
        outs = {name: m(x, t) for name, m in models.items()}
        for _ in range(2):
            for name in ("unfused", "fused", "fuse_conv", "fuse_conv", "fused", "unfused"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models[name](x, t)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    res = {}
    for name in models:
        res[f"{name}_ms"] = statistics.median(times[name])
        res[f"{name}_ms_all"] = times[name]
    if profile:
        with torch.inference_mode():
            res["profile"] = {name: profile_device(torch, lambda: m(x, t))
                              for name, m in models.items()}
    del models
    m32, _ = common.build_model_and_diffusion(dict(cfg, dtype="float32"))
    m32.load_state_dict(sd)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        y32 = m32.cuda().eval()(x, t)
    torch.backends.cudnn.allow_tf32 = True
    y0 = outs["unfused"]
    for y in outs.values():
        if tuple(y.shape) != (1, 8, *LATENT) or not bool(torch.isfinite(y).all()):
            fail("production forward gave a wrong shape or non-finite values")
    res["max_abs_diff_fused_vs_unfused"] = float((outs["fused"] - y0).abs().max())
    res["max_abs_diff_fuse_conv_vs_unfused"] = float((outs["fuse_conv"] - y0).abs().max())
    res["max_abs_diff_bf16_vs_fp32"] = float((y0 - y32).abs().max())
    res["max_abs_output"] = float(y32.abs().max())
    # the variants round in different places; they may disagree by up to
    # twice what bf16 itself costs against fp32 (the CPU test's bound)
    res["tol"] = 2.0 * res["max_abs_diff_bf16_vs_fp32"]
    if not max(res["max_abs_diff_fused_vs_unfused"],
               res["max_abs_diff_fuse_conv_vs_unfused"]) <= res["tol"]:
        fail(f"a fused forward disagrees with the unfused one: {res}")
    return res


def write_case(case_dir: str, seed: int = 0) -> None:
    """Four 240×240×155 modalities inside an ellipsoidal 'brain', zero
    outside, in BraTS file naming."""
    import numpy as np

    from fast_cwdm_tpu_torch.data.nifti import Nifti1Image, save

    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    gx, gy, gz = np.meshgrid(
        *(np.linspace(-1, 1, n, dtype=np.float32) for n in (240, 240, 155)), indexing="ij"
    )
    brain = (gx / 0.7) ** 2 + (gy / 0.8) ** 2 + (gz / 0.85) ** 2 < 1.0
    base = os.path.basename(case_dir)
    for k, m in enumerate(("t1n", "t1c", "t2w", "t2f")):
        tissue = 300 + 200 * np.sin(3 * gx + k) * np.cos(2 * gy - k) + 50 * gz
        vol = np.where(brain, tissue + 20 * rng.standard_normal(brain.shape), 0.0)
        save(Nifti1Image(np.maximum(vol, 0).astype(np.float32), np.eye(4)),
             os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))


def reset_counts():
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.diffusion import graph

    ops.set_launch_counts(dict.fromkeys(ops.launch_counts(), 0))
    graph.counts.update(captures=0, replays=0)


def read_counts() -> dict:
    from fast_cwdm_tpu_torch import ops

    return ops.launch_counts()


def check_sample(np, path: str, mask) -> list:
    """The written sample: (224, 224, 155), finite, in [0,1], zero outside
    the brain mask."""
    from fast_cwdm_tpu_torch.data.nifti import load

    got = load(path).get_fdata()
    if got.shape != (224, 224, 155) or not np.isfinite(got).all():
        fail(f"{path} has shape {got.shape} or non-finite values")
    if got.min() < 0.0 or got.max() > 1.0 or np.any(got[mask == 0] != 0.0):
        fail(f"{path} leaves [0,1] or is nonzero outside the brain mask")
    return list(got.shape)


def phase_synthesis(torch, tmp: str) -> tuple[dict, dict]:
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common, sample
    from fast_cwdm_tpu_torch.data import brats

    cfg, sd = seeded_production(torch, fuse_gn_silu=True)
    weights = os.path.join(tmp, "brats_t1c_BEST_sampled_10.pt")
    torch.save(sd, weights)
    case = os.path.join(tmp, "data", "00001")
    write_case(case)
    out_dir = os.path.join(tmp, "out")
    flags = [f"--{k}={v}" for k, v in cfg.items()] + [
        f"--data_dir={os.path.dirname(case)}", f"--model_path={weights}",
        "--contr=t1c", f"--output_dir={out_dir}", "--seed=0",
    ]

    mask = brats.load_preprocessed(os.path.join(case, "BraTS-GLI-00001-000-t1n.nii.gz"))
    mask = mask[..., 0][:, :, :155]

    # main path 1: ddpm, every GN→SiLU through K3
    reset_counts()
    timings = sample.main(flags)  # through the user's entry point
    torch.cuda.synchronize()
    counts = read_counts()
    res = {"sample_shape": check_sample(np, os.path.join(out_dir, "00001", "sample.nii.gz"), mask),
           "s_per_volume_cli_first_case": timings[0], "launches": counts,
           "graph": check_graph_counts(volumes=1)}
    if counts["haar_dwt3"] < 3 or counts["haar_idwt3"] < 1 or counts["affine_silu"] != 71 * 10:
        fail(f"the main path did not run through every kernel: {counts}")

    # main path 2: every non-up/down ResBlock's two convs through K4b
    # (27 × 2 per forward), DPM-Solver++ with 10 evaluations; as
    # ``bench.py --fused --dpm 10`` (fuse_conv without fuse_gn_silu)
    conv_dir = os.path.join(tmp, "out_fuse_conv")
    reset_counts()
    timings = sample.main(flags + [f"--output_dir={conv_dir}", "--fuse_gn_silu=False",
                                   "--fuse_conv=True", "--sampler=dpm++", "--sampling_steps=10"])
    torch.cuda.synchronize()
    conv_counts = read_counts()
    res["fuse_conv_dpm"] = {
        "sample_shape": check_sample(np, os.path.join(conv_dir, "00001", "sample.nii.gz"), mask),
        "s_per_volume_cli_first_case": timings[0], "launches": conv_counts}
    # by kernel: what route() gives the 54 production convs, × 10
    # evaluations; levels 0 and 1 (20 sites) must be among the wgmma ones,
    # levels 3 and 4 (24 sites) on split-K, no bf16 conv on mma.sync
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

    routes = {shape: tc.route(torch.bfloat16, 1, shape[1], shape[2], *shape[0])
              for shape in PRODUCTION_CONVS}
    want = {k: 10 * sum(n for shape, n in PRODUCTION_CONVS.items() if routes[shape] == k)
            for k in ("wgmma", "splitk", "mma_sync")}
    res["fuse_conv_dpm"]["launches_expected_by_kernel"] = want
    if (conv_counts["conv3d_fused_k4b"] != 54 * 10 or conv_counts["conv3d_fused_k4a"]
            or conv_counts["conv3d_fused_v4"] or conv_counts["haar_dwt3"] < 3
            or conv_counts["haar_idwt3"] != 1
            or any(conv_counts[f"conv3d_{k}"] != n for k, n in want.items())
            or want["mma_sync"]
            or any(routes[shape] != "wgmma" for shape in PRODUCTION_CONVS if shape[0][0] >= 56)
            or any(routes[shape] != "splitk" for shape in PRODUCTION_CONVS if shape[0][0] <= 14)):
        fail(f"the fused-conv path did not run through its kernels as expected: {conv_counts}")

    res["fuse_conv_dpm"]["graph"] = check_graph_counts(volumes=1)
    res.update(phase_synthesis_fn(torch, np, cfg, sd, case))
    return res, counts, conv_counts


def check_graph_counts(volumes: int, steps: int = 10) -> dict:
    """Graphs captured and replayed since the last reset_counts: a CLI run
    of one model over ``volumes`` volumes of a ``steps``-step chain captures
    one step (after two eager warm-up steps) and replays it for every other
    step."""
    from fast_cwdm_tpu_torch.diffusion import graph

    want = {"captures": 1, "replays": volumes * steps - 2}
    if graph.counts != want:
        fail(f"the run did not go through the captured chain: {graph.counts}, expected {want}")
    return dict(graph.counts)


SYNTH_VARIANTS = {"unfused": ({}, "ddpm"), "fused": (dict(fuse_gn_silu=True), "ddpm"),
                  "fuse_conv_ddpm": (dict(fuse_conv=True), "ddpm"),
                  "fuse_conv_dpm": (dict(fuse_conv=True), "dpm++")}
# launches per volume of each variant on the graph path
SYNTH_WANT = {"unfused": {"affine_silu": 0, "conv3d_fused_k4b": 0},
              "fused": {"affine_silu": 710, "conv3d_fused_k4b": 0},
              "fuse_conv_ddpm": {"affine_silu": 0, "conv3d_fused_k4b": 540, "conv3d_wgmma": 300,
                                 "conv3d_splitk": 240, "conv3d_mma_sync": 0},
              "fuse_conv_dpm": {"affine_silu": 0, "conv3d_fused_k4b": 540, "conv3d_wgmma": 300,
                                "conv3d_splitk": 240, "conv3d_mma_sync": 0}}


def phase_synthesis_fn(torch, np, cfg, sd, case) -> dict:
    """``make_synthesis_fn`` on the case, four variants, each eager
    (``cuda_graph=False``) and graphed: one warm-up call each (the graph's
    capture), then three timed calls each in turns, on one generator seed;
    host clock from the condition DWTs to the image on the host. The graph
    path's image against the eager one (expected bit for bit), its launches
    per volume, its capture seconds and pool memory. Then one ``devtime``
    trace of the fuse_conv dpm++ synthesis, eager and graphed (device ms,
    wall ms, busy share); and a 100-step fuse_conv ddpm chain, graphed, with
    ``chunk=None`` and ``chunk=32`` (a ragged last segment of 4)."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.data import brats
    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    item = brats.BRATSVolumes(os.path.dirname(case))[0]
    batch = {m: item[m][None] for m in brats.MODALITIES}
    runs, models = {}, {}
    for name, (flags_v, sampler) in SYNTH_VARIANTS.items():
        m, diff = common.build_model_and_diffusion({**cfg, "fuse_gn_silu": False, **flags_v})
        m.load_state_dict(sd)
        models[name] = (m, diff)
        for path in ("eager", "graph"):
            runs[f"{name}_{path}"] = common.make_synthesis_fn(
                m, diff, sampler=sampler, sampler_steps=10, device="cuda",
                cuda_graph=path == "graph")
    names = list(runs)
    order = names + names + names[::-1] + names
    times, imgs, launches = {name: [] for name in names}, {}, {}
    for k, name in enumerate(order):
        gen = torch.Generator(device="cuda").manual_seed(0)
        reset_counts()
        t0 = time.perf_counter()
        cond = common.prepare_condition(batch, "t1c", device="cuda")
        img = runs[name](cond, batch["t1n"], gen)
        seconds = time.perf_counter() - t0
        launches[name] = read_counts()
        if k < len(names):
            imgs[name] = img
        else:
            times[name].append(seconds)
            if not np.array_equal(img, imgs[name]):
                fail(f"{name}: a second call on the same seed gave another image")
    res = {}
    for name in names:
        res[f"s_per_volume_{name}"] = statistics.median(times[name])
        res[f"s_per_volume_{name}_all"] = times[name]
    bad = []
    for name in SYNTH_VARIANTS:
        e, g = imgs[f"{name}_eager"], imgs[f"{name}_graph"]
        step = runs[f"{name}_graph"].chain.graph
        res[f"graph_{name}"] = {
            "max_abs_diff_image_graph_vs_eager": float(np.abs(g - e).max()),
            "n_differ": int((g != e).sum()),
            "launches_per_volume": launches[f"{name}_graph"],
            "launches_per_volume_eager": launches[f"{name}_eager"],
            "launches_per_replay": step.launches_per_replay,
            "capture_s": step.capture_seconds, "pool_bytes_added": step.pool_bytes}
        want = SYNTH_WANT[name]
        if any(launches[f"{name}_graph"][k] != n for k, n in want.items()) \
                or launches[f"{name}_graph"] != launches[f"{name}_eager"] \
                or float(np.abs(g - e).max()) > 1e-4:
            bad.append(name)
    res["graph_pool_bytes_added_total"] = sum(
        runs[f"{n}_graph"].chain.graph.pool_bytes for n in SYNTH_VARIANTS)
    a = imgs["unfused_eager"]
    for name in ("fused", "fuse_conv_ddpm"):
        res[f"max_abs_diff_image_{name}_vs_unfused"] = float(np.abs(imgs[f"{name}_eager"] - a).max())
        res[f"mean_abs_diff_image_{name}_vs_unfused"] = float(np.abs(imgs[f"{name}_eager"] - a).mean())
    if bad:
        fail(f"the graphed synthesis disagrees with the eager one or with the expected "
             f"launches: {bad}: { {k: v for k, v in res.items() if k.startswith('graph_')} }")

    # one traced 10-evaluation fuse_conv dpm++ synthesis on each path
    cond = common.prepare_condition(batch, "t1c", device="cuda")
    res["devtime_fuse_conv_dpm"] = {
        path: devtime(lambda: runs[f"fuse_conv_dpm_{path}"](
            cond, batch["t1n"], torch.Generator(device="cuda").manual_seed(0)), iters=1)
        for path in ("eager", "graph")}

    # a 100-step ddpm chain, graphed, unchunked and in segments of 32
    m, _ = models["fuse_conv_ddpm"]
    d100 = GaussianDiffusion.named("linear", 100, "sampled", mode="i2i")
    chunked = {}
    for chunk in (None, 32):
        run = common.make_synthesis_fn(m, d100, chunk=chunk, device="cuda")
        t0 = time.perf_counter()
        chunked[chunk] = run(cond, batch["t1n"], torch.Generator(device="cuda").manual_seed(0))
        res[f"s_100_steps_chunk_{chunk}"] = time.perf_counter() - t0
        res[f"s_100_steps_chunk_{chunk}_capture_s"] = run.chain.graph.capture_seconds
        del run
    res["max_abs_diff_100_steps_chunk_none_vs_32"] = float(np.abs(chunked[None] - chunked[32]).max())
    if res["max_abs_diff_100_steps_chunk_none_vs_32"] != 0.0:
        fail(f"the 100-step chain differs between chunk None and 32: {res}")
    del runs, models
    torch.cuda.empty_cache()
    return res


def same_tree(np, a, b) -> bool:
    """Two nested dicts of numpy arrays equal key for key, bit for bit."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            same_tree(np, a[k], b[k]) for k in b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def check_synthesized(np, src: str, out_path: str, case: str, mask_mod: str = "t1n") -> dict:
    """A synthesized volume at the source's shape and affine, finite, in
    [0,1], zero outside the brain mask (of ``mask_mod``, the first condition
    modality) and in the 8-voxel X/Y border."""
    from fast_cwdm_tpu_torch.data import brats, nifti

    t1n = os.path.join(src, f"BraTS-GLI-{case}-000-{mask_mod}.nii.gz")
    head = nifti.load_header(t1n)
    img = nifti.load(out_path)
    vol = img.get_fdata()
    mask = brats.unprocess_volume(brats.load_preprocessed(t1n)[..., 0][:, :, :155],
                                  raw_shape=head.shape)
    if vol.shape != (240, 240, 155) or head.shape != vol.shape or not np.array_equal(img.affine, head.affine):
        fail(f"{case}: synthesized {vol.shape} with affine {img.affine.tolist()}, source {head.shape}")
    if not np.isfinite(vol).all() or vol.min() < 0.0 or vol.max() > 1.0:
        fail(f"{case}: the synthesized volume is not finite in [0, 1]")
    if np.any(vol[mask == 0] != 0.0) or vol[:8].any() or vol[-8:].any() or vol[:, :8].any() \
            or vol[:, -8:].any():
        fail(f"{case}: the synthesized volume is nonzero outside the brain mask or in the border")
    return {"shape": list(vol.shape), "max": float(vol.max()), "nonzero": int((vol > 0).sum())}


def check_completed(np, in_dir: str, out_dir: str, case: str, missing: str | None) -> dict:
    """One output case of complete_dataset: all four modalities, every
    present file byte-identical to its input, the synthesized one checked by
    check_synthesized; a complete case passed through as it was."""
    import filecmp

    from fast_cwdm_tpu_torch.data import brats

    src, out = os.path.join(in_dir, case), os.path.join(out_dir, case)
    names = sorted(os.listdir(out))
    if any(not any(f"-{m}." in n for n in names) for m in brats.MODALITIES):
        fail(f"{out} lacks a modality: {names}")
    for n in os.listdir(src):
        if not filecmp.cmp(os.path.join(src, n), os.path.join(out, n), shallow=False):
            fail(f"{out}/{n} differs from its input")
    if missing is None:
        if names != sorted(os.listdir(src)):
            fail(f"the complete case {case} was not passed through as it was: {names}")
        return {"passed_through": names}
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order

    return check_synthesized(np, src, os.path.join(out, f"{case}-{missing}.nii.gz"), case,
                             mask_mod=condition_order(missing)[0])


def phase_completion(torch, tmp: str) -> dict:
    """The production weights as a JAX-layout ``.ckpt`` (one EMA shadow equal
    to the params, a sidecar as the JAX package writes it), written and read
    back bit for bit; then ``cli.complete_dataset`` on the card over two
    240×240×155 cases without t1c and one complete case, (a) with the
    sidecar as written (unfused ddpm: 3 K1 + 1 K2 per case), (b) with
    ``fuse_conv: true`` added and ``--sampler dpm++ --sampling_steps 10``
    (540 K4b per case: 300 wgmma, 240 split-K); then ``cli.sample_auto`` on
    the same tree with the sidecar as written."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common, complete_dataset, sample_auto
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.training import checkpoints

    cfg, sd = seeded_production(torch)
    model, _ = common.build_model_and_diffusion(cfg)
    params = jax_params_from_state_dict(sd, model)
    ckpt_dir = os.path.join(tmp, "ckpt")
    path = os.path.join(ckpt_dir, "brats_t1c_BEST_sampled_10.ckpt")
    sidecar = {k: v for k, v in cfg.items() if k not in ("fuse_gn_silu", "fuse_conv")}
    sidecar.update(contr="t1c")
    t0 = time.perf_counter()
    checkpoints.save_checkpoint(path, {"params": params, "ema_params": (params,), "step": 0}, sidecar)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = checkpoints.load_with_ema_probe(path)
    read_s = time.perf_counter() - t0
    if not (same_tree(np, loaded["params"], params) and len(loaded["ema_params"]) == 1
            and same_tree(np, loaded["ema_params"][0], params)):
        fail("the production .ckpt did not read back bit for bit")
    common.load_params(path, model, use_ema=True)
    if any(not torch.equal(model.state_dict()[k], v) for k, v in sd.items()):
        fail("the production .ckpt did not load into the model bit for bit")
    del model, loaded, params
    res = {"ckpt": {"bytes": os.path.getsize(path), "write_s": write_s, "read_s": read_s,
                    "n_params": sum(v.numel() for v in sd.values())}}

    in_dir = os.path.join(tmp, "complete_in")
    cases = {"00001": "t1c", "00002": "t1c", "00003": None}
    for k, (case, missing) in enumerate(cases.items()):
        write_case(os.path.join(in_dir, case), seed=k)
        if missing:
            os.remove(os.path.join(in_dir, case, f"BraTS-GLI-{case}-000-{missing}.nii.gz"))
    n_synth = sum(m is not None for m in cases.values())

    def run(name, main, argv, want):
        out_dir = os.path.join(tmp, name)
        reset_counts()
        got = main(argv + [f"--output_dir={out_dir}"])
        torch.cuda.synchronize()
        counts = read_counts()
        bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
        if bad:
            fail(f"{name}: launches (got, expected) {bad}; all counts {counts}")
        counts["graph"] = check_graph_counts(volumes=n_synth)
        return out_dir, got, counts

    flags = [f"--input_dir={in_dir}", f"--checkpoint_dir={ckpt_dir}", "--seed=0"]
    idle = {"affine_silu": 0, "conv3d_fused_k4a": 0, "conv3d_fused_k4b": 0, "conv3d_fused_v4": 0,
            "conv3d_wgmma": 0, "conv3d_splitk": 0, "conv3d_mma_sync": 0}
    haar = {"haar_dwt3": 3 * n_synth, "haar_idwt3": n_synth}
    runs = {
        "complete_a": ([], dict(idle, **haar)),
        "complete_b": (["--sampler=dpm++", "--sampling_steps=10"],
                       dict(idle, **haar, conv3d_fused_k4b=540 * n_synth,
                            conv3d_wgmma=300 * n_synth, conv3d_splitk=240 * n_synth)),
    }
    vols = {}
    for name, (extra, want) in runs.items():
        if name == "complete_b":  # a sidecar that routes every ResBlock conv through K4b
            with open(path + ".json", "w") as f:
                json.dump(dict(sidecar, fuse_conv=True), f, indent=2)
        out_dir, got, counts = run(name, complete_dataset.main, flags + extra, want)
        if got["failed"] or sorted(got["seconds"]) != sorted(c for c, m in cases.items() if m):
            fail(f"{name}: {got}")
        checked = {case: check_completed(np, in_dir, out_dir, case, m) for case, m in cases.items()}
        res[name] = {"s_per_case": got["seconds"], "failed": got["failed"], "launches": counts,
                     "launches_expected": want, "outputs": checked}
        vols[name] = {case: nifti.load(os.path.join(out_dir, case, f"{case}-{m}.nii.gz")).dataobj
                      for case, m in cases.items() if m}
    res["max_abs_diff_a_vs_b"] = max(float(np.abs(vols["complete_a"][c] - vols["complete_b"][c]).max())
                                     for c in vols["complete_a"])
    res["volumes_differ_a_vs_b"] = res["max_abs_diff_a_vs_b"] > 0.0

    # sample_auto: the sidecar as written, bf16, ddpm
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    out_dir, got, counts = run("sample_auto", sample_auto.main,
                               [f"--data_dir={in_dir}", f"--checkpoint_dir={ckpt_dir}",
                                "--dtype=bfloat16"], dict(idle, **haar))
    if (got["done"], got["skipped"], got["failed"]) != (n_synth, len(cases) - n_synth, 0) \
            or sorted(os.listdir(out_dir)) != sorted(c for c, m in cases.items() if m):
        fail(f"sample_auto: {got}, wrote {sorted(os.listdir(out_dir))}")
    res["sample_auto"] = {"s_per_case": got["seconds"], "launches": counts, "outputs": {
        case: check_synthesized(np, os.path.join(in_dir, case),
                                os.path.join(out_dir, case, f"{case}-{m}.nii.gz"), case)
        for case, m in cases.items() if m}}
    return res


# (channels, spatial) of every GN+SiLU site of the production UNet, with
# its count per forward (71 in all; models/unet.py on the meta device)
GN_SITES = {
    (64, (112, 112, 80)): 9, (128, (112, 112, 80)): 3, (192, (112, 112, 80)): 1,
    (64, (56, 56, 40)): 2, (128, (56, 56, 40)): 9, (192, (56, 56, 40)): 1,
    (256, (56, 56, 40)): 2, (128, (28, 28, 20)): 10, (256, (28, 28, 20)): 3,
    (384, (28, 28, 20)): 1, (128, (14, 14, 10)): 2, (256, (14, 14, 10)): 9,
    (384, (14, 14, 10)): 1, (512, (14, 14, 10)): 2, (256, (7, 7, 5)): 13,
    (512, (7, 7, 5)): 3,
}
VJP_TOL = ("gx: 0 (bit for bit, the same fp32 operations each rounded once); ga, gb: "
           "1e-5 of the sum of the terms' magnitudes (summation order)")
TRAIN_STEPS = 4  # optimizer steps of each cli.train run
# the ResBlocks use_checkpoint recomputes at ds <= 1 (remat_max_ds's
# default): level 0's two ResBlocks and its down block, and the decoder's
# three level-0 ResBlocks; two GN+SiLU sites each
REMAT_GN_SITES = 12


def vjp_ratio(torch, ec, got, ref, x, g, a, b) -> float:
    """The VJP kernel's worst tolerance ratio (≤ 1 passes): gx must equal
    the plain version's; ga and gb within 1e-5 of Σ|du·x| and Σ|du|."""
    gx, ga, gb = got
    rx, ra, rb = ref
    if not torch.equal(gx, rx):
        return float("inf")
    _, ta, tb = ec.affine_silu_bwd_plain(x.abs(), g.abs(), a.abs(), b.abs())
    return max(float(((ga - ra).abs() / (1e-5 * ta + 1e-30)).max()),
               float(((gb - rb).abs() / (1e-5 * tb + 1e-30)).max()))


def phase_vjp_kernel(torch) -> dict:
    """The K3 VJP kernel at every distinct GN+SiLU shape of the production
    UNet, bf16 channels_last_3d (the training path) and fp32 contiguous:
    against affine_silu_bwd_plain, and a second launch bit for bit; then its
    time per shape (bf16 channels_last_3d, median, L2 flushed) and per train
    step (71 sites), the bound, and the plain version's time at level 0."""
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec

    g = torch.Generator(device="cuda").manual_seed(7)
    checks, worst_err, worst_ratio, per_shape = [], 0.0, 0.0, []
    step_ms = step_bound = 0.0
    for (c, sp), n in GN_SITES.items():
        for dtype, fmt in ((torch.bfloat16, "channels_last_3d"), (torch.float32, "contiguous")):
            x = torch.randn((1, *sp, c), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
            gr = torch.randn((1, *sp, c), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
            if fmt == "contiguous":
                x, gr = x.contiguous(), gr.contiguous()
            a = torch.randn((1, c), generator=g, device="cuda")
            b = torch.randn((1, c), generator=g, device="cuda")
            got = ec.affine_silu_bwd(x, gr, a, b)
            again = ec.affine_silu_bwd(x, gr, a, b)
            ref = ec.affine_silu_bwd_plain(x, gr, a, b)
            ratio = vjp_ratio(torch, ec, got, ref, x, gr, a, b)
            err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(got, ref))
            twice = all(torch.equal(o, p) for o, p in zip(got, again))
            checks.append(dict(c=c, spatial=list(sp), dtype=str(dtype).split(".")[-1], format=fmt,
                               plan=list(ec.bwd_plan(x, gr, got[0])), max_abs_err=err,
                               tol_ratio=ratio, gx_n_differ=int((got[0] != ref[0]).sum()),
                               bit_identical_twice=twice))
            worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio)
            if dtype == torch.bfloat16:
                nb = 3 * x.numel() * 2 + 4 * a.numel() * 4
                b_ms, b_by = bound_ms(nb, 12 * x.numel())
                ms = time_ms(torch, lambda: ec.affine_silu_bwd(x, gr, a, b), reps=10)
                per_shape.append(dict(c=c, spatial=list(sp), sites_per_forward=n, ms=ms,
                                      bound_ms=b_ms, bound_by=b_by))
                step_ms += n * ms
                step_bound += n * b_ms
            del x, gr, got, again, ref
    bad = [c for c in checks if not (c["tol_ratio"] <= 1.0 and c["bit_identical_twice"])]
    if bad:
        fail(f"the K3 VJP kernel disagrees with its plain version or itself: {bad}")
    # level 0, 64 channels: the record of the kernels line
    c, sp = 64, (112, 112, 80)
    x = torch.randn((1, *sp, c), generator=g, device="cuda").to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    gr = torch.randn((1, *sp, c), generator=g, device="cuda").to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    a = torch.randn((1, c), generator=g, device="cuda")
    b = torch.randn((1, c), generator=g, device="cuda")
    nb = 3 * x.numel() * 2 + 4 * a.numel() * 4
    b_ms, b_by = bound_ms(nb, 12 * x.numel())
    torch.cuda.empty_cache()
    return dict(
        shape=list(x.shape), dtype="bfloat16", format="channels_last_3d",
        max_abs_err=worst_err, tol_ratio=worst_ratio, tol=VJP_TOL,
        ms=time_ms(torch, lambda: ec.affine_silu_bwd(x, gr, a, b)),
        plain_ms=time_ms(torch, lambda: ec.affine_silu_bwd_plain(x, gr, a, b), reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nb,
        per_step_ms=step_ms, per_step_bound_ms=step_bound, per_shape=per_shape,
        checks=checks,
    )


def train_flags(data_dir: str, ckpt_dir: str, steps: int, **extra) -> list:
    """``run.sh``'s COMMON and TRAIN flags for ``cli.train`` (contr t1c),
    cut to ``steps`` optimizer steps with a BEST save at the last, a log
    line every step, the 10-step sampled schedule and the cached dataset."""
    flags = dict(
        # COMMON
        dims=3, num_groups=32, num_channels=64, num_res_blocks=2, channel_mult="1,2,2,4,4",
        attention_resolutions="", bottleneck_attention=False, image_size=112, in_channels=32,
        out_channels=8, resample_2d=False, use_scale_shift_norm=False, additive_skips=False,
        diffusion_steps=10, sample_schedule="sampled", noise_schedule="linear",
        predict_xstart=True, mode="i2i", dataset="brats", dtype="bfloat16",
        # TRAIN
        data_dir=data_dir, lr=1e-5, batch_size=1, log_interval=1, save_interval=steps,
        lr_anneal_steps=steps, use_checkpoint=True, num_workers=12, checkpoint_dir=ckpt_dir,
        contr="t1c", cache_dataset=True, seed=0,
    )
    flags.update(extra)
    return [f"--{k}={v}" for k, v in flags.items()]


def run_train(torch, tmp: str, name: str, argv: list, steps: int) -> dict:
    """One ``cli.train`` run on the card: its launches per step, warm
    s/step, peak memory, losses, and how far the parameters moved from the
    run's own init (the same seed builds the same init)."""
    import contextlib

    from fast_cwdm_tpu_torch.cli import train
    from fast_cwdm_tpu_torch.models.factory import create_model_and_diffusion

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with open(os.path.join(tmp, f"{name}.stdout"), "w") as out, contextlib.redirect_stdout(out):
        loop = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in loop.step_log]
    if loop.preempted or loop.state.step != steps or len(losses) != steps \
            or not all(math.isfinite(v) for v in losses):
        fail(f"{name}: cli.train did not run {steps} finite steps: {loop.step_log}")
    torch.manual_seed(0)
    init, _ = create_model_and_diffusion(**loop.config)
    with torch.no_grad():
        moved = {k: float((p.float().cpu() - init.state_dict()[k]).abs().max())
                 for k, p in loop.state.params.items()}
    res = {
        "seconds": seconds, "steps": steps,
        "s_per_step_warm": statistics.median(r["seconds_per_step"] for r in loop.step_log[1:]),
        "s_per_step_all": [r["seconds_per_step"] for r in loop.step_log],
        "max_memory_allocated_bytes": peak, "losses": losses,
        "params_changed": sum(v > 0 for v in moved.values()), "params_total": len(moved),
        "params_unchanged": [k for k, v in moved.items() if v == 0],
        "max_abs_param_change": max(moved.values()),
        "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()},
        "n_params": sum(p.numel() for p in loop.state.params.values()),
    }
    del loop, init
    return res


def profile_train_step(torch, flags: dict) -> dict:
    """One production train step (batch 1, bf16, use_checkpoint) traced by
    ``profile_device`` after two warm steps, on seeded weights and a random
    batch."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from fast_cwdm_tpu_torch.training import state, train

    cfg, sd = seeded_production(torch, use_checkpoint=True, **flags)
    model, _ = common.build_model_and_diffusion(cfg)
    model.load_state_dict(sd)
    model.cuda()
    diffusion = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    opt = train.make_optimizer(1e-5, lr_anneal_steps=1000)
    step = train.make_train_step(model, diffusion, opt, contr="t1c")
    st = state.TrainState.create(model, opt, ema_rates=(0.9999,))
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {m: torch.rand((1, *VOLUME, 1), generator=g, device="cuda")
             for m in ("t1n", "t1c", "t2w", "t2f")}
    rng = train.StepRNG.seeded(0, "cuda")
    for _ in range(2):
        step(st, batch, rng)
    out = profile_device(torch, lambda: step(st, batch, rng))
    del model, st, opt
    torch.cuda.empty_cache()
    return out


def phase_training(torch, tmp: str, profile: bool = False) -> dict:
    """The K3 VJP kernel, then production training through ``cli.train``
    unfused and with fuse_gn_silu, and synthesis from the BEST it wrote;
    with ``profile`` a traced train step of each."""
    import shutil

    import numpy as np

    from fast_cwdm_tpu_torch.cli import complete_dataset
    from fast_cwdm_tpu_torch.training import checkpoints

    res = {"vjp_kernel": phase_vjp_kernel(torch)}
    data = os.path.join(tmp, "data")
    for k in range(2):
        write_case(os.path.join(data, f"0000{k + 1}"), seed=10 + k)
    os.environ["OPENAI_LOGDIR"] = os.path.join(tmp, "log")
    os.environ["OPENAI_LOG_FORMAT"] = "log,csv"
    n = TRAIN_STEPS
    runs = {"unfused": (os.path.join(tmp, "ckpt_a"), {}),
            "fuse_gn_silu": (os.path.join(tmp, "ckpt_b"), {"fuse_gn_silu": True})}
    for name, (ckpt_dir, extra) in runs.items():
        r = run_train(torch, tmp, name, train_flags(data, ckpt_dir, n, **extra), n)
        k3 = (71 + REMAT_GN_SITES) * n if extra else 0
        want = {"haar_dwt3": 5 * n, "haar_idwt3": n, "affine_silu": k3,
                "affine_silu_bwd": 71 * n if extra else 0, "conv3d_fused_k4b": 0,
                "conv3d_fused_k4a": 0, "conv3d_fused_v4": 0}
        r["launches_expected"] = want
        bad = {k: (r["launches"][k], v) for k, v in want.items() if r["launches"][k] != v}
        # a tensor whose gradient is exactly 0 for these few steps (a GN
        # scale over constant groups) does not move; most must
        if bad or r["n_params"] != 81_511_048 or r["params_changed"] < 0.9 * r["params_total"]:
            fail(f"training run {name}: launches (got, expected) {bad}, {r}")
        found = checkpoints.find_best_checkpoint(ckpt_dir, "t1c")
        cfg = checkpoints.load_checkpoint_config(found[0]) if found else {}
        if not found or cfg.get("step") != n or bool(cfg.get("fuse_gn_silu")) != bool(extra):
            fail(f"training run {name} wrote no BEST at step {n}: {found} {cfg}")
        r["best"] = os.path.basename(found[0])
        res[name] = r
    # (a) without use_checkpoint: its peak memory, two steps
    try:
        r = run_train(torch, tmp, "unfused_no_remat",
                      train_flags(data, os.path.join(tmp, "ckpt_c"), 2, use_checkpoint=False), 2)
        res["unfused_no_remat"] = {k: r[k] for k in ("max_memory_allocated_bytes",
                                                     "s_per_step_warm", "losses")}
    except torch.cuda.OutOfMemoryError as e:
        res["unfused_no_remat"] = {"did_not_fit": str(e).splitlines()[0]}
    torch.cuda.empty_cache()
    res["fuse_conv_backward_raises"] = fuse_conv_backward_raises(torch)
    if profile:
        res["profile"] = {name: profile_train_step(torch, flags)
                          for name, flags in (("unfused", {}), ("fuse_gn_silu", {"fuse_gn_silu": True}))}

    # train → checkpoint → synthesis: (a)'s BEST through complete_dataset
    in_dir = os.path.join(tmp, "complete_in")
    shutil.copytree(os.path.join(data, "00001"), os.path.join(in_dir, "00001"))
    os.remove(os.path.join(in_dir, "00001", "BraTS-GLI-00001-000-t1c.nii.gz"))
    out_dir = os.path.join(tmp, "complete_out")
    reset_counts()
    got = complete_dataset.main([f"--input_dir={in_dir}", f"--output_dir={out_dir}",
                                 f"--checkpoint_dir={runs['unfused'][0]}", "--seed=0"])
    torch.cuda.synchronize()
    counts = read_counts()
    if got["failed"] or list(got["seconds"]) != ["00001"] or counts["haar_dwt3"] != 3 \
            or counts["haar_idwt3"] != 1:
        fail(f"synthesis from the trained BEST: {got}, launches {counts}")
    res["synthesis_from_trained_best"] = {
        "s_per_case": got["seconds"], "launches": counts, "graph": check_graph_counts(volumes=1),
        "output": check_completed(np, in_dir, out_dir, "00001", "t1c")}
    return res


def fuse_conv_backward_raises(torch) -> str:
    """Fault 3.2 stays guarded: backward through a fuse_conv UNet on the
    card raises (the fused conv has no VJP, nor has the JAX package's)."""
    from fast_cwdm_tpu_torch.cli import common

    cfg = common.production_config(num_channels=16, num_res_blocks=1, channel_mult="1,2",
                                   num_groups=8, image_size=8, dtype="bfloat16", fuse_conv=True)
    model, _ = common.build_model_and_diffusion(cfg)
    model.cuda()
    x = torch.randn((1, 8, 8, 8, 32), device="cuda").permute(0, 4, 1, 2, 3)
    try:
        model(x, torch.tensor([1], device="cuda")).sum().backward()
    except RuntimeError as e:
        if "no backward" in str(e):
            return str(e).splitlines()[0]
        raise
    fail("backward through a fuse_conv UNet on the card did not raise")
    return ""


REFERENCE_RUNS = {  # name: (model flags, sampler)
    "fuse_gn_silu_ddpm": (dict(fuse_gn_silu=True), "ddpm"),
    "fuse_conv_ddpm": (dict(fuse_gn_silu=True, fuse_conv=True), "ddpm"),
    "fuse_conv_ddim": (dict(fuse_gn_silu=True, fuse_conv=True), "ddim"),
    "fuse_conv_dpm": (dict(fuse_gn_silu=True, fuse_conv=True), "dpm++"),
}


def phase_reference(torch) -> dict:
    """The whole synthesis at a tiny fp32 config on the card, graphed and
    eager, against the same synthesis on the CPU, where the wrappers take
    their plain versions, which the CPU tests hold against the JAX package:
    every GN→SiLU through K3 under ddpm, then also every ResBlock conv
    through K4b under ddpm, ddim and dpm++. Same weights, same noise; TF32
    off. Tolerance 1e-4 on the [0,1] image, as the CPU tests against JAX;
    the graph against the eager chain on the card: expected bit for bit."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    rng = np.random.default_rng(0)
    vols = {m: rng.random((1, 16, 16, 16, 1)).astype(np.float32)
            for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :4] = 0.0
    noise = rng.standard_normal((1, 8, 8, 8, 8)).astype(np.float32)
    step_noise = rng.standard_normal((10, 1, 8, 8, 8, 8)).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for name, (flags, sampler) in REFERENCE_RUNS.items():
        cfg = common.production_config(
            num_channels=16, num_res_blocks=1, channel_mult="1,2", num_groups=8,
            image_size=8, diffusion_steps=10, sample_schedule="sampled",
            dtype="float32", **flags,
        )
        out, k4b = {}, {}
        for path, dev, graphed in (("cpu", "cpu", False), ("eager", "cuda", False),
                                   ("graph", "cuda", True)):
            model, diffusion = common.build_model_and_diffusion(cfg)
            shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in seeded_state_dict(shapes).items()})
            run = common.make_synthesis_fn(model, diffusion, crop_z=12, sampler=sampler,
                                           device=dev, cuda_graph=graphed)
            cond = common.prepare_condition(vols, "t1c", device=dev)
            before = tc.conv3d_fused.launches_k4b
            out[path] = run(cond, vols["t1n"], noise=noise, step_noise=step_noise)
            k4b[path] = tc.conv3d_fused.launches_k4b - before
        res[name] = {"shape": list(out["graph"].shape), "tol": 1e-4,
                     "max_image": float(out["cpu"].max()), "k4b_launches": k4b}
        for path in ("eager", "graph"):
            res[name][f"max_abs_err_{path}_vs_cpu"] = float(np.abs(out[path] - out["cpu"]).max())
        res[name]["max_abs_diff_graph_vs_eager"] = float(np.abs(out["graph"] - out["eager"]).max())
        if not (max(res[name]["max_abs_err_eager_vs_cpu"], res[name]["max_abs_err_graph_vs_cpu"],
                    res[name]["max_abs_diff_graph_vs_eager"]) <= 1e-4
                and np.isfinite(out["graph"]).all() and np.isfinite(out["eager"]).all()):
            fail(f"the synthesis on the card disagrees with the CPU's: {name} {res[name]}")
        if flags.get("fuse_conv") and (k4b["eager"], k4b["graph"]) != (160, 160):
            fail(f"the tiny fuse_conv synthesis launched K4b {k4b}, expected 160 on the card")
    torch.backends.cudnn.allow_tf32 = True
    return res


# the model-free anchors of the JAX package's quality records: the copy rows
# of QUALITY_r04.json and the real leg of QUALITY_downstream_r04.json (the
# same in every r04/r05 downstream record), and the GT region means of the
# r05 records
QUALITY_RECORD = "QUALITY_r04.json"
DOWNSTREAM_RECORD = "QUALITY_downstream_r04.json"
REGION_RECORD = "QUALITY_downstream_sampled10_r05.json"
EVAL_TRAIN_STEPS = 4  # run.sh --mode train, cut from 5,000


def start_run_sh(tmp: str, name: str, *args: str) -> tuple:
    """Start ``fast_cwdm_tpu_torch/run.sh`` with ``args`` in a child process
    (its ``python`` this interpreter), each CLI process it runs appending
    its launch counts to a file of run ``name``'s own at exit."""
    bin_dir = os.path.join(tmp, "bin")
    python = os.path.join(bin_dir, "python")
    if not os.path.exists(python):
        os.makedirs(bin_dir, exist_ok=True)
        with open(python, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(python, 0o755)
    counts_file = os.path.join(tmp, f"counts_{name}.jsonl")
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ.get('PATH', '')}",
               FAST_CWDM_LAUNCH_COUNTS=counts_file,
               OPENAI_LOGDIR=os.path.join(tmp, "log", name), OPENAI_LOG_FORMAT="log,csv")
    cmd = ["bash", os.path.join(REPO, "fast_cwdm_tpu_torch", "run.sh"), *args]
    out, err = (open(os.path.join(tmp, f"run_{name}.{x}"), "w+") for x in ("out", "err"))
    return args, subprocess.Popen(cmd, env=env, stdout=out, stderr=err), counts_file, out, err


def finish_run_sh(run: tuple) -> tuple[list, str]:
    """Wait for a run of :func:`start_run_sh`; the launch counts of each CLI
    process it ran, and its stdout. Fails on a nonzero exit."""
    args, proc, counts_file, out, err = run
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if rc != 0:
        fail(f"run.sh {' '.join(args)} exited {rc}: {stdout[-2000:]} {stderr[-3000:]}")
    with open(counts_file) as f:
        return [json.loads(line) for line in f], stdout


def expect_counts(name: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    if bad:
        fail(f"{name}: launches (got, expected) {bad}; all counts {got}")


def phase_evaluation(torch, tmp: str) -> dict:
    """The BraSyn evaluation chain at full size (240×240×155 phantoms, the
    production config of run.sh's COMMON bundle, bf16), through the port's
    entry points: ``scripts.quality_bench`` stage gen (2 train and 4 val
    phantoms, val seeds 10000-10003); ``run.sh --mode train`` (t1c, sampled
    10, 4 steps: K1 5 and K2 1 per step) into the bench's
    ``ckpt_sampled_10``; ``quality_bench`` stage eval (copy rows equal to
    QUALITY_r04.json's within 1e-9; legs sampled-10 and +ema, a 4-step
    pipeline check whose quality means nothing); ``cli.drop_modality``
    (seed 123456); then at once, in three children and this process:
    ``run.sh --mode complete`` from the trained weights (under the name of
    every modality the draw dropped), as written (3 K1 + 1 K2 per case) and
    with ``fuse_conv`` in the sidecars and dpm++ 10 (540 K4b per case: 300
    wgmma, 240 split-K), ``run.sh --mode sample``, and
    ``scripts.downstream_bench`` (real leg and GT region means equal to the
    JAX records within 1e-12); then ``cli.prepare_nnunet_dataset``,
    ``cli.evaluate_synthesis --mode direct`` on the card on the sampled
    tree, and ``ssim3d``/``psnr`` on the card against the same functions on
    the CPU for one full-size pair."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import drop_modality, prepare_nnunet_dataset
    from fast_cwdm_tpu_torch.cli import evaluate_synthesis as ev
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.scripts import downstream_bench, quality_bench
    from fast_cwdm_tpu_torch.training import checkpoints

    with open(os.path.join(REPO, QUALITY_RECORD)) as f:
        copy_ref = {r["leg"]: r for r in json.load(f)["rows"] if r["model"] == "-"}
    with open(os.path.join(REPO, DOWNSTREAM_RECORD)) as f:
        real_ref = json.load(f)["legs"]["real"]
    with open(os.path.join(REPO, REGION_RECORD)) as f:
        region_ref = json.load(f)["gt_region_means"]
    res, seconds = {}, {}
    work = os.path.join(tmp, "qb")
    qb_flags = [f"--workdir={work}", "--train_cases=2", "--val_cases=4",
                "--schedules=sampled:10"]
    t0 = time.perf_counter()

    # 1. phantoms
    quality_bench.main(qb_flags + ["--stages=gen"])
    train_dir, val_dir = os.path.join(work, "train"), os.path.join(work, "val")
    cases = sorted(d for d in os.listdir(val_dir) if os.path.isdir(os.path.join(val_dir, d)))
    if cases != ["10000", "10001", "10002", "10003"] or len(os.listdir(train_dir)) != 3:
        fail(f"stage gen wrote {cases} and {sorted(os.listdir(train_dir))}")
    seconds["gen"] = time.perf_counter() - t0

    # 2. training through run.sh, into the bench's checkpoint directory
    t1 = time.perf_counter()
    ckpt_dir = quality_bench.ckpt_dir_for(quality_bench.parse_args(qb_flags), "sampled", 10)
    n = EVAL_TRAIN_STEPS
    procs, out = finish_run_sh(start_run_sh(
        tmp, "train", "--mode", "train", "--train_modality", "t1c",
        "--sampling-strategy", "sampled", "--timesteps", "10", "--data_dir", train_dir,
        "--checkpoint_dir", ckpt_dir, "--extra",
        f"--lr_anneal_steps={n} --log_interval=1 --save_interval={n}"))
    idle = {"affine_silu": 0, "affine_silu_bwd": 0, "conv3d_fused_k4a": 0, "conv3d_fused_k4b": 0,
            "conv3d_fused_v4": 0, "conv3d_wgmma": 0, "conv3d_splitk": 0, "conv3d_mma_sync": 0}
    if len(procs) != 1 or "[TIMING] Training for t1c completed" not in out:
        fail(f"run.sh --mode train: {procs} {out[-2000:]}")
    expect_counts("run.sh --mode train", procs[0]["launches"],
                  dict(idle, haar_dwt3=5 * n, haar_idwt3=n))
    found = checkpoints.find_best_checkpoint(ckpt_dir, "t1c")
    cfg = checkpoints.load_checkpoint_config(found[0]) if found else {}
    if not found or cfg.get("step") != n or found[1:] != ("sampled", 10):
        fail(f"run.sh --mode train wrote no BEST at step {n}: {found} {cfg}")
    best = found[0]
    res["train"] = {"best": os.path.basename(best), "bytes": os.path.getsize(best),
                    "launches_per_step": {k: v / n for k, v in procs[0]["launches"].items()}}
    seconds["train"] = time.perf_counter() - t1

    # 3. quality_bench stage eval on the card
    t1 = time.perf_counter()
    reset_counts()
    rows = quality_bench.main(qb_flags + ["--stages=eval"])
    torch.cuda.synchronize()
    got = read_counts()
    expect_counts("quality_bench stage eval", got,
                  dict(idle, haar_dwt3=2 * 3 * len(cases), haar_idwt3=2 * len(cases)))
    by_leg = {r["leg"]: r for r in rows}
    if list(by_leg) != ["copy-t1n", "copy-t2w", "copy-t2f", "sampled-10", "sampled-10+ema"]:
        fail(f"stage eval rows: {list(by_leg)}")
    res["copy_rows_vs_record"] = {
        leg: {k: by_leg[leg][k] - copy_ref[leg][k] for k in ("ssim_mean", "ssim_min", "psnr_mean")}
        for leg in ("copy-t1n", "copy-t2w", "copy-t2f")}
    worst = max(abs(d) for v in res["copy_rows_vs_record"].values() for d in v.values())
    res["copy_rows_max_abs_diff_vs_record"] = worst
    if not worst <= 1e-9:
        fail(f"the copy rows differ from {QUALITY_RECORD}: {res['copy_rows_vs_record']}")
    for leg in ("sampled-10", "sampled-10+ema"):
        r = by_leg[leg]
        if not (all(-1.0 <= r[k] <= 1.0 for k in ("ssim_mean", "ssim_min"))
                and math.isfinite(r["psnr_mean"]) and r["s_per_volume"] > 0):
            fail(f"model row {leg}: {r}")
    res["quality_rows"] = rows
    res["quality_launches"] = got
    seconds["quality_eval"] = time.perf_counter() - t1

    # 4. drop_modality; then three run.sh children at once: completion from
    # the trained weights under the name of every modality (the draw drops
    # t1c, t1n and t2f), as written (a) and with fuse_conv in the sidecars
    # and dpm++ 10 (b), and run.sh --mode sample; meanwhile downstream_bench
    # in this process (its launches are this process's counts, each child's
    # its own). Nothing of theirs is timed: only the host start-up overlaps.
    t1 = time.perf_counter()
    drop_dir = os.path.join(tmp, "dropped")
    drop_modality.main([f"--input_dir={val_dir}", f"--output_dir={drop_dir}"])
    missing = {}
    for case in cases:
        marks = [f for f in os.listdir(os.path.join(drop_dir, case)) if f.startswith("missing_")]
        missing[case] = marks[0][len("missing_"):-len(".txt")]
    res["dropped"] = missing
    with open(best + ".json") as f:
        sidecar = json.load(f)
    runs = {"complete_a": ([], {}, dict(idle, haar_dwt3=3 * len(cases), haar_idwt3=len(cases))),
            "complete_b": (["--extra", "--sampler=dpm++ --sampling_steps=10"], {"fuse_conv": True},
                           dict(idle, haar_dwt3=3 * len(cases), haar_idwt3=len(cases),
                                conv3d_fused_k4b=540 * len(cases), conv3d_wgmma=300 * len(cases),
                                conv3d_splitk=240 * len(cases)))}
    samp = os.path.join(tmp, "sampled")
    torch.cuda.empty_cache()  # the children share the card with this process
    started = {}
    try:
        for name, (extra, side, _) in runs.items():
            cdir = os.path.join(tmp, f"ckpt_{name}")
            os.makedirs(cdir)
            for m in ("t1n", "t1c", "t2w", "t2f"):
                dst = os.path.join(cdir, checkpoints.best_checkpoint_name(m, "sampled", 10))
                os.link(best, dst)
                with open(dst + ".json", "w") as f:
                    json.dump(dict(sidecar, contr=m, **side), f, indent=2)
            started[name] = start_run_sh(tmp, name, "--mode", "complete", "--val_dir", drop_dir,
                                         "--output_dir", os.path.join(tmp, name),
                                         "--checkpoint_dir", cdir, *extra)
        started["sample"] = start_run_sh(
            tmp, "sample", "--mode", "sample", "--train_modality", "t1c",
            "--sampling-strategy", "sampled", "--timesteps", "10",
            "--val_dir", val_dir, "--output_dir", samp, "--checkpoint_dir", ckpt_dir)

        # 5. downstream_bench on the same val tree and checkpoint
        reset_counts()
        down = downstream_bench.main([f"--workdir={os.path.join(tmp, 'downstream')}",
                                      f"--val_dir={val_dir}", f"--checkpoint_dir={ckpt_dir}",
                                      "--sampler=dpm++", "--sampling_steps=10"])
        torch.cuda.synchronize()
        got = read_counts()
        finished = {name: finish_run_sh(run) for name, run in started.items()}
    finally:
        for run in started.values():  # a failure stops every child
            if run[1].poll() is None:
                run[1].kill()
                run[1].wait()
    expect_counts("downstream_bench", got,
                  dict(idle, haar_dwt3=3 * len(cases), haar_idwt3=len(cases)))
    real = down["legs"]["real"]
    res["downstream"] = {
        "device": down["device"], "real": {k: real[k] for k in ("n", "dice_mean", "dice_mean_ref")},
        "real_vs_record": {k: real[k] - real_ref[k] for k in ("dice_mean", "dice_mean_ref")},
        "gt_region_means": down["gt_region_means"],
        "gt_region_means_vs_record": {k: down["gt_region_means"][k] - v
                                      for k, v in region_ref.items()},
        "synth": {k: down["legs"]["synth_dpm++-10"][k] for k in ("n", "dice_mean")},
        "agreement": down["agreement"]}
    diffs = list(res["downstream"]["real_vs_record"].values()) + list(
        res["downstream"]["gt_region_means_vs_record"].values())
    if real["n"] != real_ref["n"] or not max(abs(d) for d in diffs) <= 1e-12:
        fail(f"the downstream real leg or GT region means differ from the records: "
             f"{res['downstream']}")
    models = len(set(missing.values()))
    for name, (_, _, want) in runs.items():
        procs, out = finished[name]
        if len(procs) != 1 or f"done: {len(cases)} ok, 0 failed" not in out:
            fail(f"run.sh --mode complete ({name}): {out[-2000:]}")
        expect_counts(f"run.sh --mode complete ({name})", procs[0]["launches"], want)
        graph = {"captures": models, "replays": 10 * len(cases) - 2 * models}
        if procs[0]["graph"] != graph:
            fail(f"{name}: graph counts {procs[0]['graph']}, expected {graph}")
        res[name] = {"launches_per_case": {k: v / len(cases) for k, v in procs[0]["launches"].items()},
                     "graph": procs[0]["graph"],
                     "outputs": {c: check_completed(np, drop_dir, os.path.join(tmp, name), c, m)
                                 for c, m in missing.items()}}
    procs, _ = finished["sample"]
    expect_counts("run.sh --mode sample", procs[0]["launches"],
                  dict(idle, haar_dwt3=3 * len(cases), haar_idwt3=len(cases)))
    seconds["drop_complete_sample_downstream"] = time.perf_counter() - t1

    # 6. nnU-Net layout of the completed tree
    t1 = time.perf_counter()
    raw = os.path.join(tmp, "nnunet_raw")
    prepare_nnunet_dataset.main([f"--input_dir={os.path.join(tmp, 'complete_a')}",
                                 f"--nnunet_raw={raw}"])
    ds = os.path.join(raw, "Dataset137_BraTS2023")
    with open(os.path.join(ds, "dataset.json")) as f:
        n_train = json.load(f)["numTraining"]
    images, labels = sorted(os.listdir(os.path.join(ds, "imagesTr"))), os.listdir(
        os.path.join(ds, "labelsTr"))
    if n_train != len(cases) or len(images) != 4 * len(cases) or len(labels) != len(cases):
        fail(f"prepare_nnunet_dataset: {n_train} cases, {len(images)} images, {len(labels)} labels")
    res["nnunet"] = {"numTraining": n_train, "images": len(images), "labels": len(labels)}
    seconds["nnunet"] = time.perf_counter() - t1

    # 7. evaluate_synthesis --mode direct on the card, on run.sh --mode
    # sample's output, alone on the machine (its s/case is reported)
    t1 = time.perf_counter()
    report = ev.main(["--mode=direct", f"--sample_dir={samp}",
                      f"--report={os.path.join(tmp, 'evaluation_report.json')}"])
    eval_s = time.perf_counter() - t1
    if report["n"] != len(cases) or not all(
            -1.0 <= r["ssim"] <= 1.0 and math.isfinite(r["psnr"]) for r in report["cases"]):
        fail(f"evaluate_synthesis: {report}")
    res["sample_evaluate"] = {"report": {k: v for k, v in report.items() if k != "cases"},
                              "evaluate_s_per_case": eval_s / len(cases)}
    seconds["evaluate"] = eval_s

    # 8. ssim3d / psnr on the card against the CPU, one full-size pair
    t1 = time.perf_counter()
    s = nifti.load(os.path.join(samp, cases[0], "sample.nii.gz")).get_fdata()
    g = nifti.load(os.path.join(samp, cases[0], "target.nii.gz")).get_fdata()
    on = {dev: (torch.from_numpy(s).to(dev), torch.from_numpy(g).to(dev)) for dev in ("cpu", "cuda")}
    vals, ms = {}, {}
    for dev, (a, b) in on.items():
        times = []
        for _ in range(3 if dev == "cuda" else 1):
            if dev == "cuda":
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            vals[dev] = (ev.ssim3d(a, b), ev.psnr(a, b))  # float() synchronises
            times.append((time.perf_counter() - t2) * 1e3)
        ms[dev] = min(times)
    res["metric_card_vs_cpu"] = {
        "shape": list(s.shape), "ssim": vals, "ms_ssim_psnr": ms,
        "ssim_abs_diff": abs(vals["cuda"][0] - vals["cpu"][0]),
        "psnr_abs_diff": abs(vals["cuda"][1] - vals["cpu"][1])}
    if not (res["metric_card_vs_cpu"]["ssim_abs_diff"] <= 1e-10
            and res["metric_card_vs_cpu"]["psnr_abs_diff"] <= 1e-10):
        fail(f"ssim3d/psnr on the card differ from the CPU: {res['metric_card_vs_cpu']}")
    seconds["metric_card_vs_cpu"] = time.perf_counter() - t1
    res["seconds_by_step"] = seconds
    return res


# the conv entries run on one of three hand-written kernels, by
# conv3d_cuda.route
CONV_SOURCES = ("fast_cwdm_tpu_torch/ops/csrc/conv3d_wgmma.cu (bf16, wgmma, levels 0-2) + "
                "fast_cwdm_tpu_torch/ops/csrc/conv3d_splitk.cu (bf16, split-K, levels 3-4) + "
                "fast_cwdm_tpu_torch/ops/csrc/conv3d.cu (mma.sync, fp32)")
KERNELS = {  # name: (source, replaces, key of its kernels-phase record)
    "haar_dwt3": ("fast_cwdm_tpu_torch/ops/csrc/haar3d.cu",
                  "fast_cwdm_tpu/ops/wavelet_pallas.py:53 (_dwt3_kernel)", "haar_dwt3"),
    "haar_idwt3": ("fast_cwdm_tpu_torch/ops/csrc/haar3d.cu",
                   "fast_cwdm_tpu/ops/wavelet_pallas.py:80 (_idwt3_kernel)", "haar_idwt3"),
    "affine_silu": ("fast_cwdm_tpu_torch/ops/csrc/affine_silu.cu",
                    "fast_cwdm_tpu/ops/elementwise_pallas.py:66 (_affine_silu_kernel)",
                    "affine_silu"),
    "conv3d_fused_k4a": (CONV_SOURCES, "fast_cwdm_tpu/ops/conv3d_pallas.py:36 (_kernel)", "k4a"),
    "conv3d_fused_k4b": (CONV_SOURCES, "fast_cwdm_tpu/ops/conv3d_pallas.py:154 (_blocked_kernel)",
                         "k4b"),
    "conv3d_fused_v4": (CONV_SOURCES, "fast_cwdm_tpu/ops/conv3d_pallas.py:341 (_v4_make_kernel)",
                        "k5"),
    # the K3 VJP replaces plain XLA (a custom VJP with no pallas_call)
    "affine_silu_bwd": ("fast_cwdm_tpu_torch/ops/csrc/affine_silu.cu",
                        "fast_cwdm_tpu/ops/elementwise_pallas.py:155 (_affine_silu_bwd, the VJP of "
                        "the pallas_call at :90)", "vjp_kernel"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one forward and one train step of each kind with "
                         "torch.profiler")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from fast_cwdm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 2
    if not os.path.abspath(_build.__file__).startswith(REPO + os.sep):
        print(f"chip_smoke: the port's package is not this checkout's ({_build.__file__})",
              file=sys.stderr)
        return 2

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    per_source = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": per_source})
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    t0 = time.perf_counter()
    kern = phase_kernels(torch, F)
    kern.update(phase_conv(torch, F))
    emit({"phase": "kernels", "gpu": smi, "seconds": time.perf_counter() - t0, **kern})
    t0 = time.perf_counter()
    fwd = phase_forward(torch, args.profile)
    emit({"phase": "forward", "gpu": smi, "seconds": time.perf_counter() - t0, **fwd})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res, counts, conv_counts = phase_synthesis(torch, tmp)
    emit({"phase": "synthesis", "gpu": smi, "seconds": time.perf_counter() - t0, **res})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        comp = phase_completion(torch, tmp)
    emit({"phase": "completion", "gpu": smi, "seconds": time.perf_counter() - t0, **comp})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_training(torch, tmp, args.profile)
    emit({"phase": "training", "gpu": smi, "seconds": time.perf_counter() - t0, **train})
    kern["vjp_kernel"] = train["vjp_kernel"]
    t0 = time.perf_counter()
    ref = phase_reference(torch)
    emit({"phase": "reference", "seconds": time.perf_counter() - t0, **ref})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        evaluation = phase_evaluation(torch, tmp)
    emit({"phase": "evaluation", "gpu": smi, "seconds": time.perf_counter() - t0, **evaluation})

    line = []
    for name, (source, replaces, key) in KERNELS.items():
        k = kern[key]
        # launches: from the main path that runs the kernel (K1-K3: the
        # K3 CLI run; the conv entries: the fused-conv CLI run; the K3 VJP:
        # the fuse_gn_silu training run)
        launches = (train["fuse_gn_silu"]["launches"] if name == "affine_silu_bwd" else
                    conv_counts if name.startswith("conv3d") else counts)[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": k["max_abs_err"], "tol": k["tol"],
            "tol_ratio": k.get("tol_ratio"),
            "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
            "kernel": k.get("kernel"), "mma_sync_ms": k.get("mma_sync_ms"),
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
        # per volume of every main-path run: the two CLI syntheses and the
        # completion runs (per case)
        line[-1]["launches_by_path"] = {
            "sample_ddpm_fuse_gn_silu": counts[name], "sample_fuse_conv_dpm": conv_counts[name],
            **{run: comp[run]["launches"][name] // len(comp[run]["s_per_case"])
               for run in ("complete_a", "complete_b", "sample_auto")},
            **{f"train_{run}_per_step": train[run]["launches_per_step"][name]
               for run in ("unfused", "fuse_gn_silu")},
            # phase evaluation: run.sh --mode train per step, run.sh --mode
            # complete per case as written (a) and with fuse_conv (b)
            "evaluation_train_per_step": evaluation["train"]["launches_per_step"][name],
            **{f"evaluation_{run}_per_case": evaluation[run]["launches_per_case"][name]
               for run in ("complete_a", "complete_b")}}
        if name.startswith("conv3d"):
            line[-1]["launches_by_kernel"] = {
                kn: conv_counts[f"conv3d_{kn}"] for kn in ("wgmma", "splitk", "mma_sync")}
            line[-1]["deep_levels"] = kern["deep_levels"]
    emit({"kernels": line})
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
