"""The channel-width probe of the level-0 conv (port of
``scripts/probe_lane_ceiling.py``): how fast does the card run the
112×112×80 3³ conv at 64 channels against 128 and more, and does an
X-fold to 128 channels pay?

(a) ``F.conv3d`` bf16 (cuDNN, ``channels_last_3d``) at the level-0
    spatial shape for the six (Ci, Co) pairs of the JAX script, in device
    ms (``devtime(events=True)``: calls enqueued back to back, L2 warm) and
    TFLOP/s; beside it the fused GN→SiLU→conv kernel K4b on the
    route ``conv3d_cuda.route`` picks (wgmma at level 0) for every pair
    whose shape it takes, with its TFLOP/s and the operation bound
    (2·voxels·27·Ci·Co over the card's bf16 tensor-core peak): the
    H100 form of the N = 128 question for the wgmma kernel.
(b) one semantics-preserving channel-packing transform: space-to-depth
    fold along X, (112,112,80,64) → (56,112,80,128), with an exactly
    equivalent folded kernel (parity asserted on a small fp32 shape, TF32
    off). The folded conv has 2× the MACs (structural zeros in its
    kernel), so it wins only if the 64-channel rate is below half the
    128-channel rate.

    python -m fast_cwdm_tpu_torch.scripts.probe_lane_ceiling

``--device`` defaults to ``cuda``; without a GPU the run raises unless
``--device cpu`` is given (device times are then 0.0 and K4b is not
timed; ``--quick`` shrinks the spatial shape). Prints one JSON object last;
:func:`main` returns it.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

L0 = (112, 112, 80)
QUICK_L0 = (8, 8, 8)
PAIRS = [(64, 64), (128, 128), (64, 128), (128, 64), (64, 192), (192, 192)]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (700 W)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    ap.add_argument("--quick", action="store_true",
                    help="a tiny spatial shape: a harness check, not a measurement")
    return ap.parse_args(argv)


def conv(x, w):
    """SAME 3³ conv of channels-last ``x`` (B, X, Y, Z, Ci) with a DHWIO
    kernel (3, 3, 3, Ci, Co) → (B, X, Y, Z, Co) (cross-correlation, as
    ``lax.conv_general_dilated``), through ``F.conv3d`` on a
    ``channels_last_3d`` view."""
    import torch.nn.functional as F

    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def fold_x(x):
    """(B, X, Y, Z, C) -> (B, X/2, Y, Z, 2C): adjacent-X pairs to channels."""
    b, xs, ys, zs, c = x.shape
    return x.reshape(b, xs // 2, 2, ys, zs, c).permute(
        0, 1, 3, 4, 2, 5
    ).reshape(b, xs // 2, ys, zs, 2 * c)


def unfold_x(y):
    b, xs, ys, zs, c2 = y.shape
    c = c2 // 2
    return y.reshape(b, xs, ys, zs, 2, c).permute(
        0, 1, 4, 2, 3, 5
    ).reshape(b, xs * 2, ys, zs, c)


def fold_kernel(w):
    """3x3x3 (Ci,Co) numpy kernel -> exactly-equivalent 3x3x3 (2Ci,2Co)
    kernel on the X-folded layout: Wf[fx, ky, kz, cp*Ci+c, q*Co+o] =
    W[dx, ky, kz, c, o] with dx = 2*fx + cp - q - 1 when 0 <= dx < 3,
    else 0."""
    kx, ky, kz, ci, co = w.shape
    assert kx == 3
    wf = np.zeros((3, ky, kz, 2 * ci, 2 * co), w.dtype)
    for fx in range(3):
        for cp in range(2):
            for q in range(2):
                dx = 2 * fx + cp - q - 1
                if 0 <= dx < 3:
                    wf[fx, :, :, cp * ci:(cp + 1) * ci,
                       q * co:(q + 1) * co] = w[dx]
    return wf


def k4b_leg(x, w, flops):
    """K4b (``conv3d_fused(block_x=2)``, GN-apply → SiLU → conv + bias) on
    the card at this shape: its route, device ms, TFLOP/s and the
    operation bound; None where no bf16 route takes the shape."""
    import torch

    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
    from fast_cwdm_tpu_torch.ops import launch_counts, launches_since
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    bsz, xs, ys, zs, ci = x.shape
    co = w.shape[-1]
    route = tc.route(x.dtype, bsz, ci, co, xs, ys, zs)
    if route == "mma_sync":
        return None
    xn = x.permute(0, 4, 1, 2, 3)
    b = torch.zeros(co, dtype=x.dtype, device=x.device)
    mean, inv = tc.group_stats(xn, math.gcd(ci, 32))
    gn = (mean, inv, torch.ones(ci, device=x.device), torch.zeros(ci, device=x.device))
    packed = tc.pack_wgmma_weights(w)
    before = launch_counts()
    ms = devtime(lambda: tc.conv3d_fused(xn, w, b, gn=gn, block_x=2, w_packed=packed),
                 events=True)["total_ms"]
    return {"route": route, "ms": ms, "tflops_s": flops / (ms * 1e-3) / 1e12 if ms else 0.0,
            "bound_ms": flops / PEAK_BF16_FLOPS * 1e3, "launches": launches_since(before)}


def main(argv=None) -> dict:
    import torch

    from fast_cwdm_tpu_torch import resolve_device
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    # a channels-last (B, X, Y, Z, C) tensor is contiguous, so its NCDHW
    # view is channels_last_3d: the layout cuDNN and K4b read
    a = parse_args(argv)
    dev = resolve_device(a.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    l0 = QUICK_L0 if a.quick else L0
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict = {}

    def normal(*shape, dtype=torch.bfloat16, g=gen):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    with torch.inference_mode():
        # ---- (a) conv rate vs channel width at the L0 spatial shape ----
        for ci, co in PAIRS:
            x, w = normal(1, *l0, ci), normal(3, 3, 3, ci, co)
            ms = devtime(conv, x, w, events=True)["total_ms"]
            flops = 2 * np.prod(l0) * 27 * ci * co
            tfs = flops / (ms * 1e-3) / 1e12 if ms else 0.0
            row = {"ms": round(ms, 3), "tflops_s": round(tfs, 1)}
            line = f"conv {ci:>3}->{co:<3} @{'x'.join(map(str, l0))} bf16: {ms:7.3f} ms = {tfs:6.1f} TF/s"
            if dev.type == "cuda":
                k4b = k4b_leg(x, w, flops)
                row["k4b"] = k4b
                if k4b:
                    line += (f" | K4b ({k4b['route']}) {k4b['ms']:7.3f} ms = "
                             f"{k4b['tflops_s']:6.1f} TF/s (bound {k4b['bound_ms']:.3f} ms)")
            results[f"conv_{ci}->{co}"] = row
            print(line)

        # ---- (b) space-to-depth folded equivalent at 64->64 ------------
        # parity first, on a small f32 shape, in full fp32 (TF32 off)
        g1 = torch.Generator(device=dev).manual_seed(1)
        xs = normal(1, 16, 8, 8, 64, dtype=torch.float32)
        ws = normal(3, 3, 3, 64, 64, dtype=torch.float32, g=g1) * 0.1
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            ref = conv(xs, ws)
            wsf = torch.from_numpy(fold_kernel(ws.cpu().numpy())).to(dev)
            folded = unfold_x(conv(fold_x(xs), wsf))
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        err = float((ref - folded).abs().max())
        print(f"fold parity max|err| (f32, small): {err:.2e}")
        if not err < 1e-3:
            raise AssertionError(f"folded conv is not equivalent: max|err| {err}")
        results["fold_parity_err"] = err

        x, w = normal(1, *l0, 64), normal(3, 3, 3, 64, 64)
        wf = torch.from_numpy(fold_kernel(w.float().cpu().numpy())).to(dev, torch.bfloat16)

        def folded_conv(x, wf):
            return unfold_x(conv(fold_x(x), wf))

        def folded_conv_nofold(xf, wf):
            # steady-state variant: layout stays folded across the network,
            # fold/unfold amortized away
            return conv(xf, wf)

        ms_plain = devtime(conv, x, w, events=True)["total_ms"]
        ms_folded = devtime(folded_conv, x, wf, events=True)["total_ms"]
        xf = fold_x(x)
        ms_folded_ss = devtime(folded_conv_nofold, xf, wf, events=True)["total_ms"]
    flops = 2 * np.prod(l0) * 27 * 64 * 64
    eff = flops / (ms_plain * 1e-3) / 1e12 if ms_plain else 0.0
    print(f"plain   64->64: {ms_plain:7.3f} ms ({eff:5.1f} TF/s effective)")
    print(f"folded  (incl. fold/unfold): {ms_folded:7.3f} ms")
    print(f"folded  steady-state:        {ms_folded_ss:7.3f} ms "
          f"(2x MACs at N=128; wins only if < plain)")
    results["fold_plain_ms"] = round(ms_plain, 3)
    results["fold_full_ms"] = round(ms_folded, 3)
    results["fold_steady_ms"] = round(ms_folded_ss, 3)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
