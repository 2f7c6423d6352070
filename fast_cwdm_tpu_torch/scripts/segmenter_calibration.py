"""Stand-in segmenter sensitivity calibration (port of
``scripts/segmenter_calibration.py``; host numpy).

What can ``phantom.segment_case`` detect? Controlled degradations of the
REAL t1c, no model in the loop:

* amplitude: the gadolinium-style enhancement term ``wc·C`` of the t1c
  combination (``phantom.T1C_COMBO``) scaled by α ∈ {1.0, 0.8, 0.6, 0.5,
  0.4, 0.25, 0.0};
* displacement: the SAME term translated by d ∈ {1..4} voxels (full
  amplitude, wrong place);
* structure: the enhancement energy spread uniformly over the lesion.

Each degraded volume goes through the downstream path (raw-space volumes
→ ``segment_case`` → ``remap_labels`` → per-label Dice against the
UNDEGRADED GT labels). The degradation is exact: cases are regenerated
from their seed with the same draws, and only t1c's enhancement term
changes; α = 1, d = 0 reproduces the real t1c bit for bit.

    python -m fast_cwdm_tpu_torch.scripts.segmenter_calibration \
        --out CALIBRATION.json --seeds 10000 10001 10002 10003
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from fast_cwdm_tpu_torch.cli.evaluate_synthesis import (
    dice_score,
    mean_multilabel_dice,
)
from fast_cwdm_tpu_torch.cli.prepare_nnunet_dataset import remap_labels
from fast_cwdm_tpu_torch.data.phantom import (
    RAW_SHAPE,
    T1C_COMBO,
    generate_case,
    segment_case,
)

NNUNET_NAMES = {1: "edema", 2: "ncr", 3: "et"}


def degraded_case(
    seed: int, alpha: float = 1.0, shift=(0, 0, 0), shape=RAW_SHAPE
) -> dict[str, np.ndarray]:
    """Regenerate case ``seed`` with the t1c enhancement term scaled by
    ``alpha`` and translated by ``shift`` voxels; all other modalities,
    the GT labels, and every rng draw (gain/noise) are IDENTICAL to
    `generate_case(seed)`.

    Exactness argument: `generate_case` derives t1c as
    ``a1·t1n + a2·t2w + a3·t2f + b0 + wc·C`` pre-noise (T1C_COMBO), then
    writes ``where(brain, clip(clip(base, 0.02)·edge + noise, 1e-3)·gain, 0)``.
    The enhancement delta ``Δ = wc·(α·C_shifted − C)`` enters ``base``
    linearly; away from the clip floors (enhancement lives deep inside the
    brain) the written volume responds with the factor ``edge·gain``. So
    the written t1c is patched by ``Δ·edge·gain``, with ``edge``, ``C`` and
    the t1c gain that `generate_case` reports in its ``latents``; α=1, d=0
    gives the real t1c bit for bit (asserted in tests).
    """
    lat: dict = {}
    vols = generate_case(seed, shape, latents=lat)
    C = lat["C"]
    gain = lat["gains"]["t1c"]
    wc = T1C_COMBO[4]
    C_shift = C
    if any(shift):
        C_shift = np.roll(C, shift, axis=(0, 1, 2))
    delta = wc * (alpha * C_shift - C) * lat["edge"] * gain
    t1c = vols["t1c"].copy()
    brain = t1c > 0
    t1c[brain] = np.maximum(t1c[brain] + delta[brain], 1e-3 * gain)
    out = dict(vols)
    out["t1c"] = t1c
    return out


def flattened_case(seed: int, shape=RAW_SHAPE) -> dict[str, np.ndarray]:
    """The STRUCTURE degradation: total enhancement energy preserved but
    spread UNIFORMLY over the whole lesion (seg>0) instead of concentrated
    in the core — exactly the signature the trained models produce (r4
    ft-W=1.0 raised ET/NCR/edema by a near-constant offset; the r5 W=0.3
    model's region means are flat at the affine base). If this scores ~0
    while the matched-amplitude α row scores high, the binding constraint
    is named: spatial structure, not amplitude."""
    vols = degraded_case(seed, alpha=0.0, shape=shape)  # strip enhancement
    real = generate_case(seed, shape)
    lesion = vols["seg"] > 0
    if lesion.any():
        # matched total energy: the real enhancement integral, as a
        # uniform per-voxel lift over the lesion
        delta_total = float(
            (real["t1c"][lesion] - vols["t1c"][lesion]).sum()
        )
        vols["t1c"] = vols["t1c"].copy()
        vols["t1c"][lesion] += delta_total / float(lesion.sum())
    return vols


def eval_point(seed: int, alpha: float, shift, mode: str = "amp") -> dict:
    if mode == "flat":
        vols = flattened_case(seed)
    else:
        vols = degraded_case(seed, alpha, shift)
    pred = remap_labels(segment_case(vols))
    gt = remap_labels(vols["seg"])
    return {
        "seed": seed,
        "dice": mean_multilabel_dice(pred, gt),
        "per_label": {
            name: dice_score(pred, gt, lbl)
            for lbl, name in NNUNET_NAMES.items()
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[10000, 10001, 10002, 10003])
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[1.0, 0.8, 0.6, 0.5, 0.4, 0.25, 0.0])
    ap.add_argument("--shifts", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", default="calibration.json")
    a = ap.parse_args(argv)

    report = {"amplitude": [], "displacement": [], "structure": []}
    for alpha in a.alphas:
        rows = [eval_point(s, alpha, (0, 0, 0)) for s in a.seeds]
        entry = summarize(alpha=alpha, rows=rows)
        report["amplitude"].append(entry)
        print(f"[calib] alpha={alpha}: {fmt(entry)}")
    for d in a.shifts:
        if d == 0:
            continue  # identical to alpha=1.0
        rows = [eval_point(s, 1.0, (d, d, 0)) for s in a.seeds]
        entry = summarize(shift=d, rows=rows)
        report["displacement"].append(entry)
        print(f"[calib] shift={d}vox: {fmt(entry)}")
    rows = [eval_point(s, 1.0, (0, 0, 0), mode="flat") for s in a.seeds]
    entry = summarize(mode="flat_energy_matched", rows=rows)
    report["structure"].append(entry)
    print(f"[calib] flat(energy-matched): {fmt(entry)}")
    with open(a.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"[calib] wrote {a.out}")


def summarize(rows, **kw) -> dict:
    entry = dict(kw)
    entry["dice_mean"] = float(
        np.mean([r["dice"] for r in rows if not np.isnan(r["dice"])])
    )
    entry["per_label_mean"] = {
        name: float(np.mean([
            r["per_label"][name] for r in rows
            if not np.isnan(r["per_label"][name])
        ] or [np.nan]))
        for name in NNUNET_NAMES.values()
    }
    entry["cases"] = rows
    return entry


def fmt(e: dict) -> str:
    pl = e["per_label_mean"]
    return (f"dice={e['dice_mean']:.4f} et={pl['et']:.4f} "
            f"ncr={pl['ncr']:.4f} edema={pl['edema']:.4f}")


if __name__ == "__main__":
    main()
