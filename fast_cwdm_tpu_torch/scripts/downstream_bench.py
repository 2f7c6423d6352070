"""Downstream segmentation benchmark: the BraSyn evaluation chain end to
end on phantom completions (port of ``scripts/downstream_bench.py``).

Chain: completed dataset → nnU-Net Dataset137 layout → segmentation →
Dice against the GT labels. Pretrained nnU-Net weights are not at hand,
so the segmentation step is the classical phantom-physics inversion
(``data.phantom.segment_case``); the point is to run the same
``cli.complete_dataset`` → ``cli.prepare_nnunet_dataset`` →
``calculate_dice_scores`` code a BraTS user runs, and to measure how much
synthesis error costs downstream.

Legs:
  real    — all-real modalities through the same layout+segment+Dice path
            (the segmenter's own ceiling; no model involved)
  synth   — ``--contr`` removed from every val case, re-synthesized by the
            trained model through ``cli.complete_dataset`` on ``--device``,
            then the same path
  control — (``--with_control``) the real target through the completion
            chain's preprocess → un-crop round trip, no model

The report holds the (real − synth) Dice gap, the prediction agreement
Dice(pred_synth, pred_real), per-region intensity means and the device.
Stages are resumable (each skipped when its artifact exists):

    python -m fast_cwdm_tpu_torch.scripts.downstream_bench --workdir W \\
        --val_dir VAL --checkpoint_dir CKPTS --sampler dpm++ --sampling_steps 25

``--device`` defaults to ``cuda`` in every mode, ``--quick`` included:
without a GPU the run raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--val_dir", required=True,
                    help="complete phantom cases incl. -seg files")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--contr", default="t1c")
    ap.add_argument("--sampler", default="dpm++",
                    choices=["ddpm", "ddim", "dpm++"])
    ap.add_argument("--sampling_steps", type=int, default=25)
    ap.add_argument("--label", default="",
                    help="row label; default {sampler}-{steps}")
    ap.add_argument("--with_control", action="store_true",
                    help="add the perfect-synthesis control leg: the REAL "
                    "target passed through the completion pipeline's "
                    "preprocess→unprocess round trip (no model), which "
                    "bounds what the chain's own normalization costs")
    ap.add_argument("--write_md", default="")
    ap.add_argument("--quick", action="store_true",
                    help="harness smoke with a tiny model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    return ap.parse_args(argv)


def stage_incomplete(a) -> str:
    """val minus the target modality: the BraSyn input contract (here every
    case drops ``contr``, the model under test)."""
    out = os.path.join(a.workdir, "incomplete")
    done = os.path.join(out, ".complete")
    if os.path.exists(done):
        return out
    for case in sorted(os.listdir(a.val_dir)):
        src = os.path.join(a.val_dir, case)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(out, case)
        os.makedirs(dst, exist_ok=True)
        for f in os.listdir(src):
            if f"-{a.contr}." in f or f.startswith("."):
                continue
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
    open(done, "w").close()
    print(f"[downstream] incomplete tree → {out}")
    return out


def stage_complete(a, incomplete: str) -> str:
    from fast_cwdm_tpu_torch.cli import complete_dataset

    out = os.path.join(a.workdir, f"completed_{a.sampler}{a.sampling_steps}")
    done = os.path.join(out, ".complete")
    if os.path.exists(done):
        return out
    argv = [
        f"--input_dir={incomplete}",
        f"--output_dir={out}",
        f"--checkpoint_dir={a.checkpoint_dir}",
        f"--sampler={a.sampler}",
        f"--sampling_steps={a.sampling_steps}",
        f"--device={a.device}",
    ]
    got = complete_dataset.main(argv)
    if got["failed"]:
        raise RuntimeError(f"[downstream] completion failed for {got['failed']}")
    open(done, "w").close()
    return out


def stage_nnunet(a, input_dir: str, tag: str) -> tuple[str, str]:
    from fast_cwdm_tpu_torch.cli import prepare_nnunet_dataset

    raw = os.path.join(a.workdir, f"nnraw_{tag}")
    ds = os.path.join(raw, "Dataset137_BraTS2023")
    done = os.path.join(ds, ".complete")
    images, labels = os.path.join(ds, "imagesTr"), os.path.join(ds, "labelsTr")
    if os.path.exists(done):
        return images, labels
    prepare_nnunet_dataset.main(
        [f"--input_dir={input_dir}", f"--nnunet_raw={raw}"]
    )
    open(done, "w").close()
    return images, labels


def stage_segment(a, images: str, tag: str) -> str:
    """The nnU-Net stand-in: the phantom-physics inversion over imagesTr,
    predictions in nnU-Net label space (the layout nnU-Net writes)."""
    from fast_cwdm_tpu_torch.cli.prepare_nnunet_dataset import (
        MODALITY_CHANNELS, remap_labels,
    )
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.data.phantom import segment_case

    out = os.path.join(a.workdir, f"preds_{tag}")
    done = os.path.join(out, ".complete")
    if os.path.exists(done):
        return out
    os.makedirs(out, exist_ok=True)
    cases = sorted(
        {f.rsplit("_", 1)[0] for f in os.listdir(images) if f.endswith(".nii.gz")}
    )

    def segment(case):
        vols = {
            m: np.asarray(
                nifti.load(
                    os.path.join(images, f"{case}_{ch}.nii.gz")
                ).get_fdata(),
                np.float32,
            )
            for m, ch in MODALITY_CHANNELS.items()
        }
        pred = remap_labels(segment_case(vols))
        nifti.save(
            nifti.Nifti1Image(pred.astype(np.int16), np.eye(4)),
            os.path.join(out, f"{case}.nii.gz"),
        )
        return case

    # cases on 4 threads: numpy releases the GIL in the heavy steps (each
    # case's labels are the same as one by one)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for case in pool.map(segment, cases):
            print(f"[downstream] segmented {tag}/{case}")
    open(done, "w").close()
    return out


def stage_control(a) -> str:
    """Perfect-synthesis control: the real target through exactly the
    completion pipeline's intensity path (``load_preprocessed`` then
    ``unprocess_volume``, the round trip ``cli.complete_dataset`` applies
    around the sampler) with NO model. real − control is the cost of the
    normalization itself; synth − control isolates the model's share."""
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.data.brats import load_preprocessed, unprocess_volume

    out = os.path.join(a.workdir, "control")
    done = os.path.join(out, ".complete")
    if os.path.exists(done):
        return out
    for case in sorted(os.listdir(a.val_dir)):
        src = os.path.join(a.val_dir, case)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(out, case)
        os.makedirs(dst, exist_ok=True)
        for f in os.listdir(src):
            if f.startswith("."):
                continue
            sp = os.path.join(src, f)
            if f"-{a.contr}." in f:
                hdr = nifti.load_header(sp)
                vol = load_preprocessed(sp)  # (224,224,160,1) normalized
                full = unprocess_volume(vol, raw_shape=hdr.shape)
                nifti.save(
                    nifti.Nifti1Image(
                        full.astype(np.float32), hdr.affine, hdr.header
                    ),
                    os.path.join(dst, f),
                )
            else:
                shutil.copy2(sp, os.path.join(dst, f))
    open(done, "w").close()
    print(f"[downstream] control tree → {out}")
    return out


# raw BraTS label → region name (the generator's own labels, pre-remap)
RAW_REGIONS = {4: "et", 1: "ncr", 2: "edema"}


def region_means(a, tree: str) -> dict:
    """Per-case mean NORMALIZED target intensity inside each GT lesion
    region, plus the healthy-brain MAE against the real target.
    Intensities via ``load_preprocessed`` (the training-normalized space);
    regions via the RAW GT labels of the val tree."""
    from fast_cwdm_tpu_torch.data import reduce
    from fast_cwdm_tpu_torch.data.brats import load_preprocessed, load_seg

    rows = {}
    for case in sorted(os.listdir(a.val_dir)):
        vsrc = os.path.join(a.val_dir, case)
        tsrc = os.path.join(tree, case)
        if not (os.path.isdir(vsrc) and os.path.isdir(tsrc)):
            continue

        def find(d, tag):
            for f in sorted(os.listdir(d)):
                if f"-{tag}." in f:
                    return os.path.join(d, f)
            return None

        t1c_p, seg_p = find(tsrc, a.contr), find(vsrc, "seg")
        real_p = find(vsrc, a.contr)
        if not (t1c_p and seg_p and real_p):
            continue
        x = load_preprocessed(t1c_p)[..., 0]
        real = load_preprocessed(real_p)[..., 0]
        seg = load_seg(seg_p)[..., 0]
        row = {}
        # float32 means in numpy 2.0's summation order, on every host
        for lbl, name in RAW_REGIONS.items():
            m = seg == lbl
            row[name] = float(reduce.mean(x[m])) if m.any() else None
        healthy = (real > 0) & (seg == 0)
        row["healthy_mae"] = float(reduce.mean(np.abs(x - real)[healthy]))
        rows[case] = row
    means = {}
    for name in list(RAW_REGIONS.values()) + ["healthy_mae"]:
        vals = [r[name] for r in rows.values() if r.get(name) is not None]
        means[name] = float(np.mean(vals)) if vals else None
    return {"mean": means, "cases": rows}


def agreement(a, preds_a: str, preds_b: str) -> float | None:
    """Mean foreground Dice between the two legs' PREDICTIONS: would the
    downstream consumer decide the same on synthesized data?"""
    from fast_cwdm_tpu_torch.cli.evaluate_synthesis import mean_multilabel_dice
    from fast_cwdm_tpu_torch.data import nifti

    vals = []
    for f in sorted(os.listdir(preds_a)):
        if not f.endswith(".nii.gz"):
            continue
        other = os.path.join(preds_b, f)
        if not os.path.exists(other):
            continue
        pa = np.rint(nifti.load(os.path.join(preds_a, f)).get_fdata())
        pb = np.rint(nifti.load(other).get_fdata())
        d = mean_multilabel_dice(pa, pb)
        if not np.isnan(d):  # nan = no lesion in either → uninformative
            vals.append(d)
    return float(np.mean(vals)) if vals else None


def main(argv=None) -> dict:
    """Run the chain; returns the report it writes."""
    import torch

    from fast_cwdm_tpu_torch import resolve_device

    a = parse_args(argv)
    dev = resolve_device(a.device)  # no GPU and no --device cpu: raise first
    os.makedirs(a.workdir, exist_ok=True)
    label = a.label or f"{a.sampler}-{a.sampling_steps}"

    incomplete = stage_incomplete(a)
    completed = stage_complete(a, incomplete)

    from fast_cwdm_tpu_torch.cli.evaluate_synthesis import calculate_dice_scores

    report = {"label": label, "legs": {},
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    preds = {}
    legs = [("real", a.val_dir), (f"synth_{label}", completed)]
    if a.with_control:
        legs.append(("control", stage_control(a)))
    for tag, tree in legs:
        images, labels = stage_nnunet(a, tree, tag)
        preds[tag] = stage_segment(a, images, tag)
        scores = calculate_dice_scores(preds[tag], labels)
        if tag != "real":
            # is the lesion's intensity structure preserved where the GT
            # says the lesion is?
            scores["region_means"] = region_means(a, tree)
        report["legs"][tag] = scores
        print(f"[downstream] {tag}: dice_mean={scores['dice_mean']} "
              f"per_label={scores['dice_per_label_mean']} (n={scores['n']})")
    report["agreement"] = agreement(
        a, preds["real"], preds[f"synth_{label}"]
    )
    # the targets the region means are judged against (x == real ⇒ GT)
    report["gt_region_means"] = region_means(a, a.val_dir)["mean"]

    path = os.path.join(a.workdir, f"downstream_{label}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    real = report["legs"]["real"]
    synth = report["legs"][f"synth_{label}"]
    agree = report["agreement"]
    md = (
        f"| downstream Dice ({label}) | real-input {real['dice_mean']:.4f} "
        f"| synth-input {synth['dice_mean']:.4f} "
        f"| Δ {real['dice_mean'] - synth['dice_mean']:+.4f} "
        f"| prediction agreement "
        f"{'—' if agree is None else f'{agree:.4f}'} |"
    )
    print(md)
    print(f"[downstream] wrote {path}")
    if a.write_md:
        with open(a.write_md, "a") as f:
            f.write("\n" + md + "\n")
    return report


if __name__ == "__main__":
    main()
