"""BraTS evaluation dataset and the un-crop back to the raw geometry
(port of the eval path of ``fast_cwdm_tpu/data/brats.py``), numpy only.

Preprocessing: quantile clip (0.001/0.999) → min-max to [0,1] → zero-pad Z
155→160 → crop X,Y 240→224 (``[8:-8, 8:-8]``); output channels-last
``(224, 224, 160, 1)`` float32.
"""

from __future__ import annotations

import os

import numpy as np

from fast_cwdm_tpu_torch.data import nifti

SEQTYPES = ("t1n", "t1c", "t2w", "t2f", "seg")
MODALITIES = ("t1n", "t1c", "t2w", "t2f")

RAW_SHAPE = (240, 240, 155)
PADDED_Z = 160
CROP = 8  # 240 → 224 on X and Y


def clip_and_normalize(img: np.ndarray) -> np.ndarray:
    img_clipped = np.clip(img, np.quantile(img, 0.001), np.quantile(img, 0.999))
    lo, hi = np.min(img_clipped), np.max(img_clipped)
    if hi == lo:  # constant (e.g. blank) volume: zeros, not NaNs
        return np.zeros_like(img_clipped)
    return (img_clipped - lo) / (hi - lo)


def pad_crop(vol: np.ndarray) -> np.ndarray:
    """Pad Z to 160 → crop X,Y by 8 → (X', Y', Z', 1) float32."""
    out = np.zeros((vol.shape[0], vol.shape[1], PADDED_Z), dtype=np.float32)
    out[:, :, : vol.shape[2]] = vol
    return out[CROP:-CROP, CROP:-CROP, :][..., None]


def preprocess_volume(vol: np.ndarray) -> np.ndarray:
    """clip/normalize → pad Z to 160 → crop X,Y to 224 → (X,Y,Z,1) f32."""
    return pad_crop(clip_and_normalize(vol))


def load_preprocessed(path: str) -> np.ndarray:
    return preprocess_volume(nifti.load(path).get_fdata())


def unprocess_volume(vol: np.ndarray, raw_shape=None) -> np.ndarray:
    """Invert pad/crop: (224, 224, Z[, 1]) → (240, 240, 155) with zeros in
    the cropped border. ``raw_shape`` defaults to (X+16, Y+16, min(Z, 155));
    pass the source NIfTI's shape where there is one."""
    vol = np.asarray(vol)
    if vol.ndim == 4:
        vol = vol[..., 0]
    if raw_shape is None:
        raw_shape = (vol.shape[0] + 2 * CROP, vol.shape[1] + 2 * CROP,
                     min(vol.shape[2], RAW_SHAPE[2]))
    out = np.zeros(raw_shape, dtype=vol.dtype)
    out[CROP:-CROP, CROP:-CROP, :] = vol[:, :, : raw_shape[2]]
    return out


def parse_seqtype(filename: str) -> str | None:
    """``BraTS-GLI-00000-000-t1n.nii.gz`` → ``t1n``."""
    parts = filename.split("-")
    if len(parts) < 5:
        return None
    seq = parts[4].split(".")[0]
    return seq if seq in SEQTYPES else None


class BRATSVolumes:
    """Leaf-directory dataset: every directory without subdirectories that
    holds BraTS-named modality files is one case."""

    def __init__(self, directory: str, mode: str = "eval"):
        self.mode = mode
        self.directory = os.path.expanduser(directory)
        self.database: list[dict[str, str]] = []
        for root, dirs, files in sorted(os.walk(self.directory, followlinks=True)):
            if not dirs:
                datapoint = {}
                for f in sorted(files):
                    seqtype = parse_seqtype(f)
                    if seqtype:
                        datapoint[seqtype] = os.path.join(root, f)
                if datapoint:
                    self.database.append(datapoint)

    def __len__(self) -> int:
        return len(self.database)

    def __getitem__(self, idx: int) -> dict:
        filedict = self.database[idx]
        missing = "none"
        out: dict = {}
        for m in MODALITIES:
            if m in filedict:
                out[m] = load_preprocessed(filedict[m])
            else:
                missing = m
                out[m] = np.zeros((1,), dtype=np.float32)
        if self.mode in ("eval", "auto"):
            subj = filedict.get("t1n", filedict.get("t2f", "dummy_string"))
        else:
            subj = "dummy_string"
        out["missing"] = missing
        out["subj"] = subj
        out["filedict"] = filedict
        return out
