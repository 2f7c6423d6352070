"""Synthesis evaluation: SSIM/PSNR of sample/target pairs on the card, and
the downstream segmentation Dice (port of
the JAX package's ``cli/evaluate_synthesis.py``).

    python -m fast_cwdm_tpu_torch.cli.evaluate_synthesis --mode direct \\
        --sample_dir OUT [--report R.json] [--device cpu]
    python -m fast_cwdm_tpu_torch.cli.evaluate_synthesis --mode nnunet \\
        --completed_dir IMAGES --gt_dir LABELS [--work_dir W]

``psnr`` and ``ssim3d`` take tensors (or arrays) and compute in float64 on
the device of their inputs; ``evaluate_cases`` moves each pair to
``device`` (default ``cuda``: without a GPU it raises unless ``cpu`` is
passed). Dice is a count of labels and stays numpy on the host, as in the
JAX package. ``--mode nnunet`` runs ``nnUNetv2_predict`` as a subprocess
when it is on ``PATH`` and its Dataset137 weights are staged under
``<work_dir>/nnUNet_results`` (nothing is downloaded).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device

BRATS_LABELS = (1, 2, 3, 4)


def dice_score(pred: np.ndarray, truth: np.ndarray, label: int) -> float:
    """Dice of one label; nan when neither volume holds it."""
    p = pred == label
    t = truth == label
    denom = p.sum() + t.sum()
    if denom == 0:
        return float("nan")
    return float(2.0 * np.logical_and(p, t).sum() / denom)


def mean_multilabel_dice(
    pred: np.ndarray, truth: np.ndarray, labels=BRATS_LABELS
) -> float:
    """Mean FOREGROUND Dice over the labels present in either volume.

    Deliberate deviation from the reference's `dice_coef_multilabel`,
    which averages labels 0..3 INCLUDING background over a fixed /4 (the
    near-perfect background class inflates the mean). Use
    :func:`mean_multilabel_dice_ref` to compare with reference numbers."""
    scores = [dice_score(pred, truth, l) for l in labels]
    scores = [s for s in scores if not np.isnan(s)]
    return float(np.mean(scores)) if scores else float("nan")


def mean_multilabel_dice_ref(
    pred: np.ndarray,
    truth: np.ndarray,
    num_labels: int = 4,
    smooth: float = 1e-6,
) -> float:
    """The reference's `dice_coef_multilabel(gt, pred, 4)` bit for bit:
    labels 0..num_labels-1 INCLUDING background, fixed /num_labels,
    smoothed."""
    total = 0.0
    for label in range(num_labels):
        t = (truth == label).astype(np.float64)
        p = (pred == label).astype(np.float64)
        inter = float(np.sum(t * p))
        total += (2.0 * inter + smooth) / (
            float(np.sum(t)) + float(np.sum(p)) + smooth
        )
    return total / num_labels


# ---------------------------------------------------------------------------
# Image-quality metrics (SSIM / PSNR), float64 on the inputs' device
# ---------------------------------------------------------------------------


def _f64(x, device=None) -> torch.Tensor:
    """``x`` (tensor or array) as float64, on ``device`` or its own."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)


def psnr(a, b, data_range: float = 1.0) -> float:
    """PSNR in dB of two volumes (inf when equal), in float64 on ``a``'s
    device."""
    a = _f64(a)
    b = _f64(b, a.device)
    mse = float(torch.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over a ``win``-wide window along each axis in turn, by
    cumulative sums, the window truncated at the borders."""
    out = x
    pad = win // 2
    for ax in range(3):
        n = out.shape[ax]
        c = torch.cumsum(out, dim=ax)
        idx = torch.arange(n, device=x.device)
        upper = torch.clamp(idx + pad + 1, max=n)
        lower = torch.clamp(idx - pad, min=0)
        zero = torch.zeros_like(out.narrow(ax, 0, 1))
        c0 = torch.cat([zero, c], dim=ax)
        count = (upper - lower).to(out.dtype).reshape([-1 if i == ax else 1 for i in range(3)])
        out = (c0.index_select(ax, upper) - c0.index_select(ax, lower)) / count
    return out


def ssim3d(
    a,
    b,
    data_range: float = 1.0,
    k1: float = 0.01,
    k2: float = 0.03,
    win: int = 7,
) -> float:
    """Mean 3D SSIM, numerically matching
    ``skimage.metrics.structural_similarity`` defaults: a uniform ``win``
    window, the sample-covariance NP/(NP-1) factor, and the SSIM map
    averaged over the interior only (cropped by (win-1)//2 per side, so
    truncated border windows never bias the score). Float64 on ``a``'s
    device, by cumulative sums."""
    a = _f64(a)
    b = _f64(b, a.device)
    # skimage requires an odd window; win=1 would make the sample-covariance
    # factor divide by zero, and an even win would desync the (win-1)//2
    # interior crop from the filter footprint
    if win % 2 == 0 or win < 3:
        raise ValueError(f"win must be odd and >= 3; got {win}")
    if min(a.shape) < win:
        raise ValueError(
            f"every side must be at least win={win}; got {tuple(a.shape)}"
        )
    mu_a = _uniform_filter(a, win)
    mu_b = _uniform_filter(b, win)
    # sample (not population) moments: skimage's use_sample_covariance
    cov_norm = win**3 / (win**3 - 1.0)
    saa = cov_norm * (_uniform_filter(a * a, win) - mu_a * mu_a)
    sbb = cov_norm * (_uniform_filter(b * b, win) - mu_b * mu_b)
    sab = cov_norm * (_uniform_filter(a * b, win) - mu_a * mu_b)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2)
    )
    pad = (win - 1) // 2  # mean over full-window positions only
    return float(ssim_map[pad:-pad, pad:-pad, pad:-pad].mean())


def evaluate_cases(sample_dir: str, device: str | torch.device | None = None) -> dict:
    """SSIM/PSNR/MSE over the ``{case}/sample.nii.gz`` and
    ``{case}/target.nii.gz`` pairs the sample CLI writes, computed on
    ``device`` (default ``cuda``)."""
    from fast_cwdm_tpu_torch.data import nifti

    dev = resolve_device(device)
    rows = []
    for case in sorted(os.listdir(sample_dir)):
        d = os.path.join(sample_dir, case)
        sp = os.path.join(d, "sample.nii.gz")
        tp = os.path.join(d, "target.nii.gz")
        if not (os.path.exists(sp) and os.path.exists(tp)):
            continue
        s = _f64(nifti.load(sp).get_fdata(), dev)
        t = _f64(nifti.load(tp).get_fdata(), dev)
        rows.append(
            {
                "case": case,
                "ssim": ssim3d(s, t),
                "psnr": psnr(s, t),
                "mse": float(torch.mean((s - t) ** 2)),
            }
        )
    summary = {
        "n": len(rows),
        "ssim_mean": float(np.mean([r["ssim"] for r in rows])) if rows else None,
        "psnr_mean": float(np.mean([r["psnr"] for r in rows])) if rows else None,
        "cases": rows,
    }
    return summary


# ---------------------------------------------------------------------------
# nnUNet pipeline
# ---------------------------------------------------------------------------


def setup_nnunet_environment(base: str) -> dict:
    """Create and export ``nnUNet_raw``/``_preprocessed``/``_results`` under
    ``base``."""
    env = {
        "nnUNet_raw": os.path.join(base, "nnUNet_raw"),
        "nnUNet_preprocessed": os.path.join(base, "nnUNet_preprocessed"),
        "nnUNet_results": os.path.join(base, "nnUNet_results"),
    }
    for k, v in env.items():
        os.makedirs(v, exist_ok=True)
        os.environ[k] = v
    return env


def run_nnunet_prediction(
    input_dir: str, output_dir: str, dataset_id: int = 137, fold: int = 5
) -> bool:
    """``nnUNetv2_predict`` as a subprocess; False when it is not on PATH."""
    if shutil.which("nnUNetv2_predict") is None:
        print("[eval] nnUNetv2_predict not on PATH — skipping segmentation")
        return False
    cmd = [
        "nnUNetv2_predict",
        "-i", input_dir,
        "-o", output_dir,
        "-d", str(dataset_id),
        "-c", "3d_fullres",
        "-f", str(fold),
    ]
    print("[eval] running:", " ".join(cmd))
    subprocess.run(cmd, check=True)
    return True


# nnUNet Dataset137 label names after `prepare_nnunet_dataset.remap_labels`
# (BraTS 2=ED→1, 1=NCR→2, 4=ET→3)
NNUNET_LABEL_NAMES = {1: "edema", 2: "ncr", 3: "et"}


def calculate_dice_scores(pred_dir: str, gt_dir: str) -> dict:
    """Per-case Dice of ``pred_dir``'s label files against ``gt_dir``'s
    (same names): the foreground mean, the reference's formulation, and
    a per-label breakdown (edema/NCR/ET in nnU-Net label space), since one
    mean hides which structure failed."""
    from fast_cwdm_tpu_torch.data import nifti

    rows = []
    for f in sorted(os.listdir(pred_dir)):
        if not f.endswith(".nii.gz"):
            continue
        gt_path = os.path.join(gt_dir, f)
        if not os.path.exists(gt_path):
            continue
        pred = np.rint(nifti.load(os.path.join(pred_dir, f)).get_fdata())
        gt = np.rint(nifti.load(gt_path).get_fdata())
        rows.append(
            {
                "case": f,
                "dice": mean_multilabel_dice(pred, gt),
                # the reference's formulation (background included, /4,
                # smoothed) for comparison with reference baselines
                "dice_ref": mean_multilabel_dice_ref(pred, gt),
                "dice_per_label": {
                    name: dice_score(pred, gt, lbl)
                    for lbl, name in NNUNET_LABEL_NAMES.items()
                },
            }
        )
    mean = float(np.mean([r["dice"] for r in rows])) if rows else None
    mean_ref = (
        float(np.mean([r["dice_ref"] for r in rows])) if rows else None
    )
    per_label = {}
    for lbl, name in NNUNET_LABEL_NAMES.items():
        vals = [
            r["dice_per_label"][name]
            for r in rows
            if not np.isnan(r["dice_per_label"][name])
        ]
        per_label[name] = float(np.mean(vals)) if vals else None
    return {
        "n": len(rows),
        "dice_mean": mean,
        "dice_mean_ref": mean_ref,
        "dice_per_label_mean": per_label,
        "cases": rows,
    }


def main(argv=None) -> dict:
    """Evaluate and write ``--report``; returns the report."""
    p = argparse.ArgumentParser(
        description=(
            "Synthesis evaluation. --mode=direct scores sample/target "
            "pairs (SSIM/PSNR/MSE) on --device. --mode=nnunet computes the "
            "downstream segmentation Dice and needs (a) nnUNetv2_predict on "
            "PATH and (b) the pretrained BraTS Dataset137 weights staged "
            "under <work_dir>/nnUNet_results/Dataset137_BraTS2021/ "
            "beforehand (nothing is downloaded)."
        )
    )
    p.add_argument("--mode", choices=["direct", "nnunet"], default="direct")
    p.add_argument("--sample_dir", default="",
                   help="direct mode: dir of {case}/sample+target pairs")
    p.add_argument("--completed_dir", default="",
                   help="nnunet mode: nnUNet imagesTr input")
    p.add_argument("--gt_dir", default="")
    p.add_argument("--work_dir", default="./nnunet_work",
                   help="nnunet mode: root holding nnUNet_raw/preprocessed/"
                        "results; stage the Dataset137 weights under "
                        "nnUNet_results")
    p.add_argument("--report", default="evaluation_report.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.mode == "direct":
        if not args.sample_dir:
            p.error("--sample_dir is required for --mode=direct")
        report = evaluate_cases(args.sample_dir, device=device)
    else:
        env = setup_nnunet_environment(args.work_dir)
        weights = os.path.join(
            env["nnUNet_results"], "Dataset137_BraTS2021"
        )
        if not os.path.isdir(weights):
            print(
                f"[eval] NOTE: no pretrained weights at {weights} — "
                "stage the nnUNet Dataset137 folder there; "
                "nnUNetv2_predict will fail without it."
            )
        pred_dir = os.path.join(args.work_dir, "predictions")
        os.makedirs(pred_dir, exist_ok=True)
        if not args.completed_dir:
            p.error("--completed_dir is required for --mode=nnunet")
        if not args.gt_dir:
            # fail BEFORE the (hours-long) prediction pass, not after it
            # with an empty report
            p.error("--gt_dir is required for --mode=nnunet")
        if run_nnunet_prediction(args.completed_dir, pred_dir):
            report = calculate_dice_scores(pred_dir, args.gt_dir)
        else:
            report = {"error": "nnUNetv2 unavailable"}
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "cases"}))
    return report


if __name__ == "__main__":
    main()
