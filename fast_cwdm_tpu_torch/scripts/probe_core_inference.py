"""Probe: does the trained model INFER the core enhancement from the
condition, or only COPY it from x_t? (port of
``scripts/probe_core_inference.py``, the round-5 diagnosis of QUALITY.md.)

During training the model denoises x_t = q(x0_real), which already holds
the enhancement for all but the largest t, so it can learn to copy the core
out of x_t. At sampling time the chain starts from pure noise: whether a
core ever appears is decided by the x0-prediction at HIGH t, where the only
source of core information is the condition.

Per timestep t, the ET/NCR/edema region means of the model's
x0-prediction (``p_mean_variance(...)["pred_xstart"]``, what every sampler
integrates) under two input regimes:

  teacher — x_t = q_sample(x0_real, t): the training distribution;
  blind   — x_t = pure noise (the t = T marginal), at the largest t only:
            any core here can ONLY come from the condition.

Verdict rule: teacher rows that recover the core at low t while the blind
high-t rows sit at the no-enhancement base say the model never learned
cond→core inference (the training signal binds); blind rows that show the
core while sampled volumes do not say the integration loses it (the
sampler binds). The GT rows are the same region means of the real target.

    python -m fast_cwdm_tpu_torch.scripts.probe_core_inference \\
        --checkpoint_dir CKPTS --val_dir VAL --out PROBE_core_inference_torch.json

Region means and the healthy MAE are float32 means in numpy 2.0's
summation order (``data/reduce.py``), so the GT rows do not depend on the
host's numpy. ``--device`` defaults to ``cuda``; ``--quick`` (the JAX
script's flag: run on the CPU) is ``--device cpu``. The default ``--out``
is a file of the port's own, never the JAX package's committed record.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

RAW_REGIONS = {4: "et", 1: "ncr", 2: "edema"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--val_dir", required=True)
    ap.add_argument("--contr", default="t1c")
    ap.add_argument("--timesteps", type=int, nargs="+",
                    default=[999, 900, 800, 600, 400, 200, 50])
    ap.add_argument("--out", default="PROBE_core_inference_torch.json")
    ap.add_argument("--quick", action="store_true", help="run on the CPU (--device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    return ap.parse_args(argv)


def x0_pred(model, diffusion, x0_wav, cond, noise_wav, t, *, blind: bool):
    """The model's x0-prediction as a clamped image (B, X, Y, Z, 1): x_t is
    ``noise_wav`` (blind) or ``q_sample(x0_wav, t, noise_wav)`` (teacher);
    then ``p_mean_variance(..., clip_denoised=True)["pred_xstart"]``, the
    normalised IDWT (K2 on the card) and a clamp to [0, 1]. Wavelet tensors
    channels-last (B, X/2, Y/2, Z/2, C), as the JAX package's."""
    import torch

    from fast_cwdm_tpu_torch.ops import wavelet as wv

    def model_fn(x, tt):
        return model(x.permute(0, 4, 1, 2, 3), tt).float().permute(0, 2, 3, 4, 1)

    x_t = noise_wav if blind else diffusion.q_sample(x0_wav, t, noise_wav)
    out = diffusion.p_mean_variance(model_fn, x_t, t, cond=cond, clip_denoised=True)
    img = wv.idwt_normalized(out["pred_xstart"], 1, diffusion.wavelet)
    return torch.clamp(img, 0.0, 1.0)


def _find(cdir: str, tag: str) -> str | None:
    for f in sorted(os.listdir(cdir)):
        if f"-{tag}." in f:
            return os.path.join(cdir, f)
    return None


def region_row(img: np.ndarray, seg: np.ndarray) -> dict:
    """Mean of ``img`` inside each raw GT region (None where it is empty),
    float32 in numpy 2.0's order."""
    from fast_cwdm_tpu_torch.data import reduce

    row = {}
    for lbl, name in RAW_REGIONS.items():
        m = seg == lbl
        row[name] = float(reduce.mean(img[m])) if m.any() else None
    return row


def load_model(a, device):
    """BEST for ``--contr`` in ``--checkpoint_dir``: the production config
    updated by the stored config's schema keys except ``dtype`` (as the JAX
    script), the raw weights (not the EMA), on ``device``, in eval mode."""
    from fast_cwdm_tpu_torch.cli.common import (
        build_model_and_diffusion,
        load_params,
        production_config,
    )
    from fast_cwdm_tpu_torch.models.factory import model_and_diffusion_defaults
    from fast_cwdm_tpu_torch.training import checkpoints as ckpt

    found = ckpt.find_best_checkpoint(a.checkpoint_dir, a.contr, "brats")
    if found is None:
        raise SystemExit(f"no BEST checkpoint in {a.checkpoint_dir}")
    path, schedule, steps = found
    stored = ckpt.load_checkpoint_config(path) or {}
    cfg = production_config(sample_schedule=schedule, diffusion_steps=steps)
    schema = set(model_and_diffusion_defaults())
    cfg.update({k: v for k, v in stored.items() if k in schema and k != "dtype"})
    cfg.update(mode="i2i", sample_schedule=schedule, diffusion_steps=steps)
    model, diffusion = build_model_and_diffusion(cfg)
    load_params(path, model, use_ema=False)
    print(f"[probe] {os.path.basename(path)} ({schedule}, {steps} steps)")
    return model.to(device).eval(), diffusion


def main(argv=None) -> dict:
    import torch

    from fast_cwdm_tpu_torch import resolve_device
    from fast_cwdm_tpu_torch.data import reduce
    from fast_cwdm_tpu_torch.data.brats import load_preprocessed, load_seg
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    a = parse_args(argv)
    dev = resolve_device("cpu" if a.quick else a.device)
    model, diffusion = load_model(a, dev)
    if not all(0 <= t < diffusion.num_timesteps for t in a.timesteps):
        raise SystemExit(f"--timesteps {a.timesteps} outside the checkpoint's process "
                         f"(0..{diffusion.num_timesteps - 1})")
    gen = torch.Generator(device=dev).manual_seed(0)

    def as_dev(v):
        return torch.from_numpy(v).to(dev)

    rows = []
    cases = sorted(d for d in os.listdir(a.val_dir) if os.path.isdir(os.path.join(a.val_dir, d)))
    with torch.inference_mode():
        for case in cases:
            cdir = os.path.join(a.val_dir, case)
            vols = {m: load_preprocessed(_find(cdir, m))[None] for m in ("t1n", "t1c", "t2w", "t2f")}
            seg = load_seg(_find(cdir, "seg"))[..., 0]
            x0_wav = wv.dwt_normalized(as_dev(vols[a.contr]))
            cond = torch.cat([wv.dwt_normalized(as_dev(vols[m]))
                              for m in condition_order(a.contr)], dim=-1)
            noise_img = torch.randn(vols[a.contr].shape, generator=gen, device=dev)
            noise_wav = wv.dwt3_flat(noise_img, diffusion.wavelet)
            real = vols[a.contr][0, ..., 0]
            for t_int in a.timesteps:
                t = torch.full((1,), t_int, dtype=torch.int64, device=dev)
                for blind in (False, True):
                    if blind and t_int != max(a.timesteps):
                        continue  # blind regime only meaningful at chain start
                    img = x0_pred(model, diffusion, x0_wav, cond, noise_wav, t,
                                  blind=blind)[0, ..., 0].cpu().numpy()
                    row = {"case": case, "t": t_int, "regime": "blind" if blind else "teacher"}
                    row.update(region_row(img, seg))
                    healthy = (real > 0) & (seg == 0)
                    row["healthy_mae"] = float(reduce.mean(np.abs(img - real)[healthy]))
                    rows.append(row)
                    print(
                        f"[probe] {case} t={t_int} {row['regime']}: "
                        f"et={row['et']:.4f} ncr={row['ncr']:.4f} "
                        f"edema={row['edema']:.4f} mae={row['healthy_mae']:.4f}"
                        if row["et"] is not None
                        else f"[probe] {case} t={t_int}: no lesion"
                    )

    # GT anchors for the same cases
    gt = []
    for case in cases:
        cdir = os.path.join(a.val_dir, case)
        x = load_preprocessed(_find(cdir, a.contr))[..., 0]
        seg = load_seg(_find(cdir, "seg"))[..., 0]
        gt.append({"case": case, **region_row(x, seg)})

    report = {"rows": rows, "gt": gt}
    with open(a.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"[probe] wrote {a.out}")
    return report


if __name__ == "__main__":
    main()
