"""Seeded multi-modality brain phantoms in BraTS geometry, made on the device.

A frozen generator of the benchmark's inputs, after the anatomy model of the
program's ``data/phantom.py`` (four contrasts of one shared latent anatomy,
t1c an affine combination of the other three plus an enhancing core), made
with a few large torch calls on the device so that set-up stays short:

- smooth tissue fields ``c1``, ``c2`` and a fine texture: low-resolution
  normal noise, trilinearly upsampled, zero mean and unit spread;
- a lesion: an edema blob ``E`` around a random centre inside the brain, its
  enhancing core ``C`` the blob's interior;
- a brain mask: an ellipsoid with a smoothly perturbed edge; the background is
  exactly 0, the brain lies in (0, 1].

Each modality is normalised to the brain's range, padded in Z from 155 to 160
and cropped in X and Y from 240 to 224, as the program's loader prepares a
BraTS case: ``(1, 224, 224, 160, 1)`` float32 (for the production geometry).
The same seed gives the same volumes on the same device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODALITIES = ("t1n", "t1c", "t2w", "t2f")
# rows: constant, c1, c2, E, C, texture
CONTRAST = {
    "t1n": (0.40, +0.30, -0.12, -0.08, -0.05, 0.05),
    "t2w": (0.30, -0.12, +0.35, +0.22, +0.05, 0.05),
    "t2f": (0.34, -0.06, +0.28, +0.30, -0.10, 0.05),
}
T1C_COMBO = (0.55, -0.35, 0.45, 0.22, 0.32)  # t1n, t2w, t2f, constant, C


def _smooth(g, shape, res: int, device) -> torch.Tensor:
    base = torch.randn((1, 1, res, res, max(2, int(res * 0.66))), generator=g, device=device)
    f = F.interpolate(base, size=shape, mode="trilinear", align_corners=False)[0, 0]
    return (f - f.mean()) / f.std().clamp_min(1e-6)


def make_case(seed: int, geometry: dict, device) -> dict[str, torch.Tensor]:
    """The four modalities of case ``seed`` on ``device``, prepared as the
    program's loader prepares them: ``{modality: (1, X, Y, Z, 1)}``.
    ``geometry``: ``raw`` (the scanner volume, 240×240×155), ``crop_xy``
    (voxels cut from each side of X and Y) and ``pad_z`` (Z after padding)."""
    raw = tuple(int(s) for s in geometry["raw"])
    crop, pad_z = int(geometry["crop_xy"]), int(geometry["pad_z"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    gx, gy, gz = torch.meshgrid(
        *(torch.linspace(-1.0, 1.0, n, device=device) for n in raw), indexing="ij")
    edge = (gx / 0.7) ** 2 + (gy / 0.8) ** 2 + (gz / 0.85) ** 2 + 0.06 * _smooth(g, raw, 4, device)
    brain = edge < 1.0
    c1, c2, tex = (_smooth(g, raw, r, device) for r in (6, 10, 24))
    centre = (torch.rand(3, generator=g, device=device) - 0.5) * 0.6
    radius = 0.12 + 0.1 * torch.rand((), generator=g, device=device)
    dist = ((gx - centre[0]) ** 2 + (gy - centre[1]) ** 2 + (gz - centre[2]) ** 2).sqrt()
    lesion = torch.sigmoid((radius - dist + 0.05 * c2) / 0.03)
    core = torch.sigmoid((0.5 * radius - dist) / 0.02)
    fields = (torch.ones_like(c1), c1, c2, lesion, core, tex)
    vols = {m: sum(w * f for w, f in zip(CONTRAST[m], fields)) for m in CONTRAST}
    a, b, c, k, e = T1C_COMBO
    vols["t1c"] = a * vols["t1n"] + b * vols["t2w"] + c * vols["t2f"] + k + e * core
    out = {}
    for m in MODALITIES:
        v = vols[m] + 0.02 * torch.randn(raw, generator=g, device=device)
        lo, hi = v[brain].min(), v[brain].max()
        v = torch.where(brain, 0.02 + 0.98 * (v - lo) / (hi - lo).clamp_min(1e-6), 0.0)
        v = F.pad(v, (0, pad_z - raw[2]))[crop:raw[0] - crop, crop:raw[1] - crop]
        out[m] = v[None, ..., None].contiguous()
    return out
