"""Convert completed BraTS cases to the nnU-Net Dataset137 layout (port of
the JAX package's ``cli/prepare_nnunet_dataset.py``; host file work).

    python -m fast_cwdm_tpu_torch.cli.prepare_nnunet_dataset --input_dir COMPLETED \\
        --nnunet_raw RAW [--dataset_id 137] [--dataset_name BraTS2023] [--labels_dir SEGS]

Channels ``_0000..0003`` = t1n, t1c, t2w, t2f; BraTS labels remapped to
nnU-Net's (4→3, 2→1, 1→2); ``dataset.json`` written beside ``imagesTr``
and ``labelsTr``. A case without all four modalities is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

MODALITY_CHANNELS = {"t1n": "0000", "t1c": "0001", "t2w": "0002", "t2f": "0003"}
# BraTS labels (1=NCR, 2=ED, 4=ET) → nnUNet Dataset137 (2, 1, 3)
LABEL_REMAP = {4: 3, 2: 1, 1: 2}


def remap_labels(seg: np.ndarray) -> np.ndarray:
    """BraTS raw labels → nnU-Net Dataset137 labels; anything else → 0."""
    out = np.zeros_like(seg)
    for src, dst in LABEL_REMAP.items():
        out[seg == src] = dst
    return out


def main(argv=None) -> None:
    from fast_cwdm_tpu_torch.data import nifti

    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--nnunet_raw", required=True)
    p.add_argument("--dataset_id", type=int, default=137)
    p.add_argument("--dataset_name", default="BraTS2023")
    p.add_argument("--labels_dir", default="",
                   help="optional ground-truth seg directory")
    args = p.parse_args(argv)

    ds_dir = os.path.join(
        args.nnunet_raw, f"Dataset{args.dataset_id:03d}_{args.dataset_name}"
    )
    images = os.path.join(ds_dir, "imagesTr")
    labels = os.path.join(ds_dir, "labelsTr")
    os.makedirs(images, exist_ok=True)
    os.makedirs(labels, exist_ok=True)

    cases = sorted(
        d
        for d in os.listdir(args.input_dir)
        if os.path.isdir(os.path.join(args.input_dir, d))
    )
    converted = 0
    for case in cases:
        case_dir = os.path.join(args.input_dir, case)
        found = {}
        seg_path = None
        for f in sorted(os.listdir(case_dir)):
            for m in MODALITY_CHANNELS:
                if f"-{m}." in f:
                    found[m] = os.path.join(case_dir, f)
            if "-seg." in f:
                seg_path = os.path.join(case_dir, f)
        if len(found) != 4:
            print(f"[nnunet] skipping {case}: {sorted(found)} present")
            continue
        for m, ch in MODALITY_CHANNELS.items():
            shutil.copy2(
                found[m], os.path.join(images, f"{case}_{ch}.nii.gz")
            )
        if args.labels_dir:
            cand = os.path.join(args.labels_dir, f"{case}-seg.nii.gz")
            if os.path.exists(cand):
                seg_path = cand
        if seg_path:
            img = nifti.load(seg_path)
            seg = remap_labels(
                np.asarray(img.get_fdata()).astype(np.int16)
            )
            nifti.save(
                nifti.Nifti1Image(seg, img.affine, img.header),
                os.path.join(labels, f"{case}.nii.gz"),
            )
        converted += 1

    dataset_json = {
        "channel_names": {
            "0": "T1n", "1": "T1c", "2": "T2w", "3": "T2f",
        },
        "labels": {
            "background": 0,
            "whole_tumor": [1, 2, 3],
            "tumor_core": [2, 3],
            "enhancing_tumor": [3],
        },
        "regions_class_order": [1, 2, 3],
        "numTraining": converted,
        "file_ending": ".nii.gz",
    }
    with open(os.path.join(ds_dir, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    print(f"[nnunet] converted {converted} cases → {ds_dir}")


if __name__ == "__main__":
    main()
