"""Measure the elementwise wall (port of ``scripts/probe_elementwise.py``):
does the fused GN-apply+SiLU kernel (K3, ``ops/csrc/affine_silu.cu``) close
part of the elementwise time of the production forward?

Three measurements, all device time (``utils/devtime(events=True)``: CUDA
events around calls enqueued back to back behind a spin of the card; the
profiler's trace of a forward misses some of K3's records on the H100):

  A. standalone: plain torch ``silu(x·a + b)`` (fp32 ``torch.sigmoid``, as
     the JAX formula) against K3 at the level-0 production shape
     (1, 112, 112, 80, 64) bf16, in ms and effective GB/s (2 × the bf16
     bytes: one read, one write);
  B. full forward: the production UNet (``cli.common.flagship``, bf16)
     with ``fuse_gn_silu`` False and True;
  C. (if B wins) the 100-step spaced ddpm synthesis with the flag on,
     through ``make_synthesis_fn``: s/volume, the least of ``--walls``
     (3) walls (host clock),
     on the captured CUDA graph chain (``cuda_graph`` None on the card) or
     the eager one (the CPU).

    python -m fast_cwdm_tpu_torch.scripts.probe_elementwise [--skip_c]

``--device`` defaults to ``cuda``; without a GPU the run raises unless
``--device cpu`` is given (where every device time is 0.0, and
``--quick`` shrinks the shapes and the model so that the harness runs in
seconds; its numbers mean nothing). :func:`main` returns what it prints,
as a dict, with each leg's kernel launches (``ops.launches_since``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

SHAPE = (1, 112, 112, 80, 64)  # level 0 of the production UNet, channels-last
LATENT = (1, 112, 112, 80)
QUICK_SHAPE = (1, 8, 8, 8, 64)
QUICK_LATENT = (1, 8, 8, 8)
QUICK_MODEL = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip_c", action="store_true")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--walls", type=int, default=3, help="timed volumes of C")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes and model: a harness check, not a measurement")
    return ap.parse_args(argv)


def seeded_model(seed: int, device, **overrides):
    """``flagship(**overrides)`` initialised from ``seed`` (the global
    generator forked, so the caller's stream is untouched)."""
    import torch

    from fast_cwdm_tpu_torch.cli.common import flagship

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return flagship(device="cpu", **overrides).to(device)


def plain_affine_silu(x, a, b):
    """The JAX script's ``xla_version``: u = x·a + b in fp32, u·sigmoid(u),
    cast back to x's dtype."""
    import torch

    bc = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    u = x.float() * a.reshape(bc) + b.reshape(bc)
    return (u * torch.sigmoid(u)).to(x.dtype)


def main(argv=None) -> dict:
    import torch

    from fast_cwdm_tpu_torch import resolve_device
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import launch_counts, launches_since
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    a = parse_args(argv)
    dev = resolve_device(a.device)
    print("devices:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    shape, latent = (QUICK_SHAPE, QUICK_LATENT) if a.quick else (SHAPE, LATENT)
    model_kw = QUICK_MODEL if a.quick else {}
    gen = torch.Generator(device=dev).manual_seed(0)
    res: dict = {"device": str(dev)}

    # ---------------- A: standalone apply+silu at the L0 shape ----------
    nbytes = int(np.prod(shape)) * 2  # bf16
    c = shape[-1]
    # channels-last memory, logical (B, C, X, Y, Z): the UNet's layout
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    sa = torch.linspace(0.5, 1.5, c, dtype=torch.float32, device=dev)[None]
    sb = torch.linspace(-0.2, 0.2, c, dtype=torch.float32, device=dev)[None]
    fns = {"A/plain_affine_silu": plain_affine_silu, "A/k3_affine_silu": ec.affine_silu}
    res["A"] = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            before = launch_counts()
            ms = devtime(fn, x, sa, sb, iters=a.iters, events=True)["total_ms"]
            gbs = 2 * nbytes / ms / 1e6 if ms else 0.0
            res["A"][name] = {"ms": ms, "gb_s": gbs, "launches": launches_since(before)}
            print(f"{name}: {ms:.3f} ms  ({gbs:.0f} GB/s effective)")

    # ---------------- B: full flagship forward --------------------------
    lat = torch.randn((*latent, 32), generator=gen, device=dev).permute(0, 4, 1, 2, 3)
    t = torch.tensor([500], device=dev)
    # by CUDA events, as A: the profiler's trace of the fused forward misses
    # some of K3's records on the card
    models, results, launches = {}, {}, {}
    for flag in (False, True):
        models[flag] = seeded_model(1, dev, dtype=torch.bfloat16, fuse_gn_silu=flag,
                                    **model_kw).eval()
        models[flag].load_state_dict(models[False].state_dict())  # the same weights
        before = launch_counts()
        with torch.inference_mode():
            results[flag] = devtime(models[flag], lat, t, iters=a.iters, events=True)["total_ms"]
        launches[f"fuse_gn_silu={flag}"] = launches_since(before)
        print(f"B/forward fuse_gn_silu={flag}: {results[flag]:.2f} ms device")
    delta = results[False] - results[True]
    share = delta / results[False] * 100 if results[False] else 0.0
    print(f"B/delta: {delta:+.2f} ms ({share:+.1f}%)")
    res["B"] = {"forward_ms": {"fuse_gn_silu=False": results[False],
                               "fuse_gn_silu=True": results[True]},
                "delta_ms": delta, "delta_pct": share, "launches": launches}

    # ---------------- C: sampling throughput with the flag --------------
    if a.skip_c or delta <= 0:
        print("C: skipped" + (" (no forward win)" if delta <= 0 else ""))
        res["C"] = None
        return res
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.diffusion.respace import create_spaced_diffusion, space_timesteps
    from fast_cwdm_tpu_torch.diffusion.schedules import get_named_beta_schedule

    model = models.pop(True)
    del models
    spaced = create_spaced_diffusion(
        use_timesteps=space_timesteps(1000, "100"),
        betas=get_named_beta_schedule("linear", 1000, "direct"), mode="i2i")
    cond = torch.randn((*latent, 24), generator=gen, device=dev).to(torch.bfloat16)
    vol = tuple(2 * n for n in latent[1:])
    mask = np.ones((1, *vol, 1), np.float32)
    crop_z = min(155, vol[2])
    synth = common.make_synthesis_fn(model, spaced, crop_z=crop_z, device=dev)
    walls = []
    before = launch_counts()
    for i in range(a.walls):
        g = torch.Generator(device=dev).manual_seed(i)
        t0 = time.perf_counter()
        out = synth(cond, mask, g)  # returns host numpy: the chain has finished
        walls.append(time.perf_counter() - t0)
    path = "graphed" if synth.chain is not None else "eager"
    print(f"C/100-step s_per_volume (fused elementwise, {path}): min {min(walls):.3f}"
          f" walls={['%.2f' % w for w in walls]}")
    res["C"] = {"s_per_volume": min(walls), "walls": walls, "path": path,
                "shape": list(out.shape), "finite": bool(np.isfinite(out).all()),
                "launches": launches_since(before)}
    return res


if __name__ == "__main__":
    main()
