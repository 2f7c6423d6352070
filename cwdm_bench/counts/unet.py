"""Frozen operation and byte counts of the production UNet, from its shapes.

Every count is of the mathematics, once, whatever implements it: a 3³
convolution of Ci → Co channels over V output voxels is 2·27·Ci·Co·V
operations, and reads its input, its weights and writes its output once
each. A later kernel that does the same conv with less work, or a route that
does more (three TF32 products for one fp32 product), leaves these numbers
alone.

``sites(cfg, latent)`` lists the convolutions and dense layers of one
forward at a latent of spatial shape ``latent`` (X, Y, Z), in the order the
forward runs them, each as a dict with ``kind`` ("conv" or "dense"), ``ci``,
``co``, ``k`` (kernel edge), ``voxels`` (output voxels, 1 for dense) and
``fused`` (a ResBlock 3³ conv that ``fuse_conv`` routes through the fused
GN→SiLU→conv kernel: every ResBlock that neither up- nor downsamples).
"""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(__file__), "peaks.json")


def peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)


def _mults(cfg) -> tuple[int, ...]:
    m = cfg["channel_mult"]
    return tuple(int(s) for s in m.split(",")) if isinstance(m, str) else tuple(m)


def sites(cfg: dict, latent: tuple[int, int, int]) -> list[dict]:
    ch0, nrb = int(cfg["num_channels"]), int(cfg["num_res_blocks"])
    ted = 4 * ch0
    out: list[dict] = []

    def conv(ci, co, vox, k=3, fused=False):
        out.append(dict(kind="conv", ci=ci, co=co, k=k, voxels=vox, fused=fused))

    def dense(ci, co):
        out.append(dict(kind="dense", ci=ci, co=co, k=1, voxels=1, fused=False))

    def resblock(ci, co, vox, resample=None):
        v = {"down": vox // 8, "up": vox * 8}.get(resample, vox)
        conv(ci, co, v, fused=resample is None)
        dense(ted, co)
        conv(co, co, v, fused=resample is None)
        if ci != co:
            conv(ci, co, v, k=1)
        return co, v

    dense(ch0, ted)
    dense(ted, ted)
    vox = latent[0] * latent[1] * latent[2]
    conv(int(cfg["in_channels"]), ch0, vox)
    ch, skips = ch0, [ch0]
    mults = _mults(cfg)
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            ch, vox = resblock(ch, mult * ch0, vox)
            skips.append(ch)
        if level != len(mults) - 1:
            ch, vox = resblock(ch, ch, vox, "down")
            skips.append(ch)
    for _ in range(2):
        ch, vox = resblock(ch, ch, vox)
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            ch, vox = resblock(ch + skips.pop(), mult * ch0, vox)
            if level and i == nrb:
                ch, vox = resblock(ch, ch, vox, "up")
    conv(ch0, int(cfg["out_channels"]), vox)
    return out


def operations(site: dict, batch: int = 1) -> float:
    """2·k³·Ci·Co·V·B multiply-adds counted as two operations each."""
    return 2.0 * site["k"] ** 3 * site["ci"] * site["co"] * site["voxels"] * batch


def bytes_moved(site: dict, itemsize: int, batch: int = 1) -> float:
    """Input (at the output's voxels; the same count for stride 1), weights
    and output, each once."""
    acts = (site["ci"] + site["co"]) * site["voxels"] * batch
    return float(itemsize * (acts + site["k"] ** 3 * site["ci"] * site["co"]))


def forward_operations(cfg: dict, latent, batch: int = 1) -> float:
    """The model's operations in one forward: every conv and dense layer."""
    return sum(operations(s, batch) for s in sites(cfg, latent))


def fused_bound_s(cfg: dict, latent, peak_ops: float, peak_bytes: float, itemsize: int,
                  batch: int = 1) -> float:
    """Σ over the fused convs of one forward of max(ops / peak, bytes / bandwidth):
    the least time the card could take for them."""
    return sum(max(operations(s, batch) / peak_ops, bytes_moved(s, itemsize, batch) / peak_bytes)
               for s in sites(cfg, latent) if s["fused"])
