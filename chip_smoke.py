#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (what a release check runs)
    python3 chip_smoke.py --profile  # also trace one forward of each kind

Phases, each printing one JSON object per line:

1. device   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build    — compile the hand-written kernels (``ops/csrc/*.cu``) with nvcc;
3. kernels  — each kernel against its plain PyTorch version at the shapes
              of the production path, with its time, the plain version's,
              one library call's where one computes the same function, and
              the least time the card could take (bytes or operations);
4. forward  — the 81,511,048-parameter production UNet in bf16 at
              (1, 112, 112, 80, 32), fuse_gn_silu False and True, timed in
              turns; with ``--profile`` the device time by kernel;
5. synthesis— the ``fast_cwdm_tpu_torch.cli.sample`` entry point on one
              synthetic 240×240×155 BraTS case with seeded weights, 10-step
              sampled schedule, every GN→SiLU through K3; the launch counts
              of that run; then ``make_synthesis_fn`` unfused and fused;
6. reference— the whole synthesis at a tiny fp32 config on the card
              against the same on the CPU (plain versions), same noise.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and, last,
``{"ok": true, "device": {...}}``. Any failed phase exits nonzero before
the last line. Exits nonzero without a result when no CUDA device is
present or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
VOLUME = (224, 224, 160)
LATENT = (112, 112, 80)
# (channels, spatial) of the production UNet's levels where GN→SiLU runs
K3_SHAPES = ((64, (112, 112, 80)), (128, (56, 56, 40)), (256, (14, 14, 10)))


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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 25) -> float:
    """Median of ``reps`` single launches timed with CUDA events, the L2
    cache flushed before each (the synthesis path finds its inputs cold)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def profile_forward(torch, model, x, t) -> dict:
    """Device time of one forward by kernel (``torch.profiler``): the total,
    the busy share of the host-clock wall time, sums by kind, and the top
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(x, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = (("K3 affine_silu", ("affine_silu",)),
             ("convolution", ("conv", "xmma", "cudnn", "fprop", "implicit", "gemm")),
             ("reduction (GroupNorm statistics)", ("reduce",)),
             ("elementwise and copies", ("elementwise", "copy", "cat", "upsample",
                                         "avg_pool", "index")))
    sums, rows = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "device_time_total", 0)
        name = e.key.lower()
        kind = next((k for k, keys in kinds if any(w in name for w in keys)), "other")
        sums[kind] = sums.get(kind, 0.0) + us / 1e3
        rows.append((us / 1e3, e.count, e.key[:90]))
    device_ms = sum(sums.values())
    rows.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "by_kind_ms": dict(sorted(sums.items(), key=lambda kv: -kv[1])),
            "top_kernels": [dict(ms=ms, count=n, name=k) for ms, n, k in rows[:12]]}


def phase_forward(torch, profile: bool = False) -> dict:
    """The production forward unfused and fused, timed in turns (unfused,
    fused, fused, unfused; three rounds; host clock around a synchronised
    forward), and the fp32 forward as the yardstick of bf16's own error."""
    from fast_cwdm_tpu_torch.cli import common

    cfg, sd = seeded_production(torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, *LATENT, 32), generator=g, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([9], device="cuda")
    models = {}
    for fused in (False, True):
        m, _ = common.build_model_and_diffusion(dict(cfg, fuse_gn_silu=fused))
        m.load_state_dict(sd)
        models[fused] = m.cuda().eval()
    times = {False: [], True: []}
    with torch.inference_mode():
        outs = {fused: m(x, t) for fused, m in models.items()}
        for _ in range(3):
            for fused in (False, True, True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models[fused](x, t)
                torch.cuda.synchronize()
                times[fused].append((time.perf_counter() - t0) * 1e3)
    res = {"unfused_ms": statistics.median(times[False]), "unfused_ms_all": times[False],
           "fused_ms": statistics.median(times[True]), "fused_ms_all": times[True]}
    if profile:
        res["profile"] = {("fused" if f else "unfused"): profile_forward(torch, m, x, t)
                          for f, m in models.items()}
    del models
    m32, _ = common.build_model_and_diffusion(dict(cfg, dtype="float32"))
    m32.load_state_dict(sd)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        y32 = m32.cuda().eval()(x, t)
    torch.backends.cudnn.allow_tf32 = True
    y0, y1 = outs[False], outs[True]
    for y in (y0, y1):
        if tuple(y.shape) != (1, 8, *LATENT) or not bool(torch.isfinite(y).all()):
            fail("production forward gave a wrong shape or non-finite values")
    res["max_abs_diff_fused_vs_unfused"] = float((y1 - y0).abs().max())
    res["max_abs_diff_bf16_vs_fp32"] = float((y0 - y32).abs().max())
    res["max_abs_output"] = float(y32.abs().max())
    # fused and unfused round in different places; they may disagree by up
    # to twice what bf16 itself costs against fp32 (the CPU test's bound)
    res["tol"] = 2.0 * res["max_abs_diff_bf16_vs_fp32"]
    if not res["max_abs_diff_fused_vs_unfused"] <= res["tol"]:
        fail(f"fused forward disagrees with unfused: {res}")
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
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

    wc.haar_dwt3.launches = wc.haar_idwt3.launches = ec.affine_silu.launches = 0


def read_counts() -> dict:
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

    return {"haar_dwt3": wc.haar_dwt3.launches, "haar_idwt3": wc.haar_idwt3.launches,
            "affine_silu": ec.affine_silu.launches}


def phase_synthesis(torch, tmp: str) -> tuple[dict, dict]:
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common, sample
    from fast_cwdm_tpu_torch.data import brats
    from fast_cwdm_tpu_torch.data.nifti import load

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

    reset_counts()
    timings = sample.main(flags)  # the main path, through the user's entry point
    torch.cuda.synchronize()
    counts = read_counts()

    got = load(os.path.join(out_dir, "00001", "sample.nii.gz")).get_fdata()
    mask = brats.load_preprocessed(os.path.join(case, "BraTS-GLI-00001-000-t1n.nii.gz"))
    mask = mask[..., 0][:, :, :155]
    res = {"sample_shape": list(got.shape), "s_per_volume_cli_first_case": timings[0],
           "launches": counts}
    if got.shape != (224, 224, 155) or not np.isfinite(got).all():
        fail(f"sample.nii.gz has shape {got.shape} or non-finite values")
    if got.min() < 0.0 or got.max() > 1.0 or np.any(got[mask == 0] != 0.0):
        fail("sample.nii.gz leaves [0,1] or is nonzero outside the brain mask")
    if counts["haar_dwt3"] < 3 or counts["haar_idwt3"] < 1 or counts["affine_silu"] != 71 * 10:
        fail(f"the main path did not run through every kernel: {counts}")

    # the same case through make_synthesis_fn, unfused (the default) and
    # fused, on one generator seed: one warm-up each, then in turns
    # (unfused, fused, fused, unfused) twice; host clock, condition DWTs
    # through the image on the host
    item = brats.BRATSVolumes(os.path.dirname(case))[0]
    batch = {m: item[m][None] for m in brats.MODALITIES}
    runs = {}
    for fused in (False, True):
        m, diff = common.build_model_and_diffusion(dict(cfg, fuse_gn_silu=fused))
        m.load_state_dict(sd)
        runs[fused] = common.make_synthesis_fn(m, diff, device="cuda")
    times, imgs = {False: [], True: []}, {}
    for k, fused in enumerate((False, True) + (False, True, True, False) * 2):
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        cond = common.prepare_condition(batch, "t1c", device="cuda")
        imgs[fused] = runs[fused](cond, batch["t1n"], gen)
        if k >= 2:
            times[fused].append(time.perf_counter() - t0)
    for fused, name in ((False, "unfused"), (True, "fused")):
        res[f"s_per_volume_{name}"] = statistics.median(times[fused])
        res[f"s_per_volume_{name}_all"] = times[fused]
    a, b = imgs[False], imgs[True]
    res["max_abs_diff_image_fused_vs_unfused"] = float(np.abs(a - b).max())
    res["mean_abs_diff_image_fused_vs_unfused"] = float(np.abs(a - b).mean())
    return res, counts


def phase_reference(torch) -> dict:
    """The whole synthesis at a tiny fp32 config (every GN→SiLU through K3)
    on the card against the same synthesis on the CPU, where the wrappers
    take their plain versions, which the CPU tests hold against the JAX
    package. Same weights, same noise; TF32 off. Tolerance 1e-4 on the
    [0,1] image, as the CPU test against JAX."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    cfg = common.production_config(
        num_channels=16, num_res_blocks=1, channel_mult="1,2", num_groups=8,
        image_size=8, diffusion_steps=10, sample_schedule="sampled",
        dtype="float32", fuse_gn_silu=True,
    )
    rng = np.random.default_rng(0)
    vols = {m: rng.random((1, 16, 16, 16, 1)).astype(np.float32)
            for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :4] = 0.0
    noise = rng.standard_normal((1, 8, 8, 8, 8)).astype(np.float32)
    step_noise = rng.standard_normal((10, 1, 8, 8, 8, 8)).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dev in ("cpu", "cuda"):
        model, diffusion = common.build_model_and_diffusion(cfg)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in seeded_state_dict(shapes).items()})
        run = common.make_synthesis_fn(model, diffusion, crop_z=12, device=dev)
        cond = common.prepare_condition(vols, "t1c", device=dev)
        out[dev] = run(cond, vols["t1n"], noise=noise, step_noise=step_noise)
    torch.backends.cudnn.allow_tf32 = True
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    res = {"shape": list(out["cuda"].shape), "max_abs_err_cuda_vs_cpu": err, "tol": 1e-4,
           "max_image": float(out["cpu"].max())}
    if not (err <= 1e-4 and np.isfinite(out["cuda"]).all()):
        fail(f"the synthesis on the card disagrees with the CPU's: {res}")
    return res


KERNELS = {
    "haar_dwt3": ("fast_cwdm_tpu_torch/ops/csrc/haar3d.cu",
                  "fast_cwdm_tpu/ops/wavelet_pallas.py:53 (_dwt3_kernel)"),
    "haar_idwt3": ("fast_cwdm_tpu_torch/ops/csrc/haar3d.cu",
                   "fast_cwdm_tpu/ops/wavelet_pallas.py:80 (_idwt3_kernel)"),
    "affine_silu": ("fast_cwdm_tpu_torch/ops/csrc/affine_silu.cu",
                    "fast_cwdm_tpu/ops/elementwise_pallas.py:66 (_affine_silu_kernel)"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one forward of each kind with torch.profiler")
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

    kern = phase_kernels(torch, F)
    emit({"phase": "kernels", **kern})
    emit({"phase": "forward", "gpu": smi, **phase_forward(torch, args.profile)})
    with tempfile.TemporaryDirectory() as tmp:
        res, counts = phase_synthesis(torch, tmp)
    emit({"phase": "synthesis", "gpu": smi, **res})
    emit({"phase": "reference", **phase_reference(torch)})

    line = []
    for name, (source, replaces) in KERNELS.items():
        k = kern[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": k["max_abs_err"], "tol": k["tol"],
            "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    emit({"kernels": line})
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
