"""BraTS datasets for training and evaluation, the LIDC dataset, the batch
collation of training, and the un-crop back to the raw geometry (port of
``fast_cwdm_tpu/data/brats.py``), numpy only.

Preprocessing: quantile clip (0.001/0.999) → min-max to [0,1] → zero-pad Z
155→160 → crop X,Y 240→224 (``[8:-8, 8:-8]``); output channels-last
``(224, 224, 160, 1)`` float32. Seg labels keep their raw values (uint8).
"""

from __future__ import annotations

import os
from typing import Iterator

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


def load_seg(path: str) -> np.ndarray:
    """Raw BraTS labels pad/cropped to the training geometry, uint8 (labels
    are categorical: no clip or normalisation; rounded, not truncated, so a
    scaled 3.9999 stays 4)."""
    return np.rint(pad_crop(np.asarray(nifti.load(path).get_fdata(), np.float32))).astype(np.uint8)


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
    holds BraTS-named modality files is one case.

    ``mode`` "train", "eval" or "auto" (the latter two record the case's
    t1n/t2f path as ``subj``). ``cache=True`` keeps each preprocessed
    volume in host memory by path (read-only; collation copies), so later
    epochs skip the gzip decode. ``with_seg=True`` adds the case's ``seg``
    labels (an empty mask where the case has none)."""

    def __init__(self, directory: str, mode: str = "train", cache: bool = False,
                 with_seg: bool = False):
        self.mode = mode
        self.directory = os.path.expanduser(directory)
        self.with_seg = with_seg
        self._cache: dict[str, np.ndarray] | None = {} if cache else None
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

    def _load_cached(self, path: str, loader=None) -> np.ndarray:
        loader = loader or load_preprocessed
        if self._cache is None:
            return loader(path)
        vol = self._cache.get(path)
        if vol is None:
            vol = loader(path)
            # loader threads may decode one path twice; a dict set is atomic
            vol.setflags(write=False)
            self._cache[path] = vol
        return vol

    def __getitem__(self, idx: int) -> dict:
        filedict = self.database[idx]
        missing = "none"
        out: dict = {}
        for m in MODALITIES:
            if m in filedict:
                out[m] = self._load_cached(filedict[m])
            else:
                missing = m
                out[m] = np.zeros((1,), dtype=np.float32)
        if self.with_seg:
            if filedict.get("seg"):
                out["seg"] = self._load_cached(filedict["seg"], loader=load_seg)
            else:
                # a seg-less case trains with an empty mask (its lesion terms are 0)
                ref = next((out[m] for m in MODALITIES if out[m].ndim == 4), None)
                shape = ref.shape if ref is not None else (
                    RAW_SHAPE[0] - 2 * CROP, RAW_SHAPE[1] - 2 * CROP, PADDED_Z, 1)
                out["seg"] = np.zeros(shape, dtype=np.uint8)
        if self.mode in ("eval", "auto"):
            subj = filedict.get("t1n", filedict.get("t2f", "dummy_string"))
        else:
            subj = "dummy_string"
        out["missing"] = missing
        out["subj"] = subj
        out["filedict"] = filedict
        return out


class LIDCVolumes:
    """LIDC 256³ CT volumes (every ``.nii``/``.nii.gz`` in a leaf
    directory), clipped and normalised, with ``half_res`` a 2× average pool
    to 128³; items ``(X, Y, Z, 1)`` float32, for unconditional training."""

    def __init__(self, directory: str, mode: str = "train", half_res: bool = True):
        self.mode = mode
        self.half_res = half_res
        self.directory = os.path.expanduser(directory)
        self.database: list[str] = []
        for root, dirs, files in sorted(os.walk(self.directory)):
            if not dirs:
                self.database += [os.path.join(root, f) for f in sorted(files)
                                  if f.endswith((".nii", ".nii.gz"))]

    def __len__(self) -> int:
        return len(self.database)

    def __getitem__(self, idx: int) -> np.ndarray:
        vol = clip_and_normalize(nifti.load(self.database[idx]).get_fdata()).astype(np.float32)
        if self.half_res:
            s = vol.shape
            vol = vol.reshape(s[0] // 2, 2, s[1] // 2, 2, s[2] // 2, 2).mean(axis=(1, 3, 5))
        return vol[..., None]


def iterate_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    keys=MODALITIES,
    num_workers: int = 0,
    rows: tuple[int, int] | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Stacked numpy batches of ``keys`` in a seeded order (the same for any
    ``num_workers``; > 0 decodes on threads). ``rows=(start, stop)`` yields
    only those rows of each ``batch_size``-row batch (the JAX package's
    multi-host contract; one process here takes all rows). A case missing
    a collated modality raises, naming the case."""
    from fast_cwdm_tpu_torch.data.loader import iter_items, shard_order_rows

    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if rows is not None:
        if not drop_last:
            raise ValueError("rows= requires drop_last=True")
        order, batch_size = shard_order_rows(order, batch_size, rows)

    def collate(batch: list[dict]) -> dict[str, np.ndarray]:
        for b in batch:
            if b.get("missing", "none") in keys:
                where = b.get("filedict") or b.get("subj") or "?"
                raise ValueError(
                    f"case is missing modality {b['missing']!r} but the batch collates keys "
                    f"{tuple(keys)}; use mode='auto' pipelines (which read 'missing' per "
                    f"case) or drop the incomplete case; offending case files: {where}"
                )
        return {k: np.stack([b[k] for b in batch]) for k in keys}

    batch: list[dict] = []
    for item in iter_items(dataset, order, num_workers):
        batch.append(item)
        if len(batch) == batch_size:
            yield collate(batch)
            batch = []
    if batch and not drop_last:
        yield collate(batch)
