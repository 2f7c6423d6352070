"""Frozen operation and byte counts of the UNet's attention blocks, from the
configuration's shapes (``counts/unet.py`` counts the trunk's convs and dense
layers, and no attention).

``sites(cfg, latent)`` lists a forward's attention blocks in the order the
forward runs them, each as a dict with ``t`` (positions: the feature map's
voxels at the block's level), ``c`` (channels) and ``heads``. Per block:

- ``operations``: the qkv dense layer 6·T·C², proj_out 2·T·C², and the two
  products q·kᵀ and w·v 4·T²·C (multiply-adds counted as two operations);
- ``flash_operations`` / ``flash_bytes``: the attention kernel's share, the
  two products, reading q, k and v and writing the output once each.

A kernel that does more (recomputing in a backward) or less (skipping
masked blocks) leaves these numbers alone. The GroupNorms are not counted,
as ``counts/unet.py`` counts none.
"""

from __future__ import annotations

from cwdm_bench.counts import unet
from cwdm_bench.reference.cwdm_attn import attention_ds, heads_of

# substrings of the names of the flash kernel's device records (its forward
# and the split-KV pass with its combine, which the backend takes where the
# grid is small): one fused launch runs one forward, whole or split, and the
# split one's combine, whose name holds COMBINE
FLASH_KERNELS = ("flash_fwd",)
COMBINE = "combine"


def sites(cfg: dict, latent: tuple[int, int, int]) -> list[dict]:
    ch0, nrb = int(cfg["num_channels"]), int(cfg["num_res_blocks"])
    mults, att = unet._mults(cfg), attention_ds(cfg)
    vox, ds, out = latent[0] * latent[1] * latent[2], 1, []

    def site(c, decoder):
        out.append(dict(t=vox, c=c, heads=heads_of(cfg, c, decoder)))

    for level, mult in enumerate(mults):
        for _ in range(nrb):
            if ds in att:
                site(mult * ch0, False)
        if level != len(mults) - 1:
            ds, vox = ds * 2, vox // 8
    if cfg.get("bottleneck_attention", True):
        site(mults[-1] * ch0, False)
    for level, mult in reversed(list(enumerate(mults))):
        for _ in range(nrb + 1):
            if ds in att:
                site(mult * ch0, True)
        if level:
            ds, vox = ds // 2, vox * 8
    return out


def flash_operations(site: dict, batch: int = 1) -> float:
    """q·kᵀ and w·v: 4·T²·C."""
    return 4.0 * site["t"] ** 2 * site["c"] * batch


def flash_bytes(site: dict, itemsize: int, batch: int = 1) -> float:
    """q, k and v read and the output written, once each."""
    return 4.0 * site["t"] * site["c"] * itemsize * batch


def operations(site: dict, batch: int = 1) -> float:
    """The block's dense layers (qkv 6·T·C², proj_out 2·T·C²) and products."""
    return 8.0 * site["t"] * site["c"] ** 2 * batch + flash_operations(site, batch)


def forward_operations(cfg: dict, latent, batch: int = 1) -> float:
    """A forward's operations: the trunk's (``counts/unet.py``) and the
    attention blocks'."""
    return (unet.forward_operations(cfg, latent, batch)
            + sum(operations(s, batch) for s in sites(cfg, latent)))


def flash_bound_s(cfg: dict, latent, peak_ops: float, peak_bytes: float, itemsize: int,
                  batch: int = 1) -> float:
    """Σ over a forward's attention blocks of max(4·T²·C / peak, bytes /
    bandwidth): the least time the card could take for their products."""
    return sum(max(flash_operations(s, batch) / peak_ops,
                   flash_bytes(s, itemsize, batch) / peak_bytes)
               for s in sites(cfg, latent))
