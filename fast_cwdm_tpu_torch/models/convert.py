"""JAX parameter tree ↔ the port's ``state_dict``.

The port's own copy of the layout walk of the JAX package's
``training/bridge.py`` (``unet_layout``, ``_f2t_leaf``/``_t2f_leaf``,
``flax_to_torch``/``torch_to_flax``), for the UNet the port implements (no
attention blocks):

* flax Conv ``kernel`` (D, H, W, I, O) → torch ``weight`` (O, I, D, H, W);
* Dense ``kernel`` (I, O) → ``weight`` (O, I);
* GroupNorm ``scale``/``bias`` → ``weight``/``bias``.

The parameter tree is nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``, or a ``.ckpt`` read by
``training/checkpoints.py``); nothing of JAX is imported here.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from fast_cwdm_tpu_torch.models.unet import UNetModel

# per module kind: (torch suffix, flax suffix, leaf kind)
_KIND_LEAVES = {
    "conv": [("", "", "conv")],
    "linear": [("", "", "linear")],
    "norm": [("", "", "norm")],
    "downsample": [("op", "op", "conv")],
    "upsample": [("conv", "conv", "conv")],
    "res": [
        ("in_layers.0", "in_norm", "norm"),
        ("in_layers.2", "in_conv", "conv"),
        ("emb_layers.1", "emb_proj", "linear"),
        ("out_layers.0", "out_norm", "norm"),
        ("out_layers.3", "out_conv", "conv"),
        ("skip_connection", "skip", "conv"),
    ],
}


def unet_layout(model: UNetModel) -> Iterator[tuple[str, str, str]]:
    """(torch module path, flax module name, kind) for every parameterised
    module, replaying the UNet's construction bookkeeping."""
    yield "time_embed.0", "time_embed_0", "linear"
    yield "time_embed.2", "time_embed_2", "linear"
    yield "input_blocks.0.0", "input_conv", "conv"
    nrb = model.num_res_blocks
    resample = "res" if model.resblock_updown else ("downsample" if model.conv_resample else None)
    tidx, bidx = 1, 0
    for level in range(len(model.channel_mult)):
        for _ in range(nrb):
            yield f"input_blocks.{tidx}.0", f"in_{bidx}_res", "res"
            tidx += 1
            bidx += 1
        if level != len(model.channel_mult) - 1:
            if resample:
                yield f"input_blocks.{tidx}.0", f"in_{bidx}_down", resample
            tidx += 1
            bidx += 1
    yield "middle_block.0", "mid_res0", "res"
    yield "middle_block.1", "mid_res1", "res"
    upsample = "res" if model.resblock_updown else ("upsample" if model.conv_resample else None)
    bidx = 0
    for level in reversed(range(len(model.channel_mult))):
        for i in range(nrb + 1):
            yield f"output_blocks.{bidx}.0", f"out_{bidx}_res", "res"
            if level and i == nrb and upsample:
                yield f"output_blocks.{bidx}.1", f"out_{bidx}_up", upsample
            bidx += 1
    yield "out.0", "out_norm", "norm"
    yield "out.2", "out_conv", "conv"


def _f2t_leaf(kind: str, name: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    """flax leaf → (torch leaf name, array)."""
    if kind == "norm":
        return ("weight" if name == "scale" else "bias"), w
    if name == "bias":
        return "bias", w
    if kind == "conv":
        k = w.ndim - 2
        return "weight", np.transpose(w, (k + 1, k, *range(k)))
    if kind == "linear":
        return "weight", w.T
    raise ValueError(kind)


def _t2f_leaf(kind: str, name: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    """torch leaf → (flax leaf name, array)."""
    if kind == "norm":
        return ("scale" if name == "weight" else "bias"), w
    if name == "bias":
        return "bias", w
    if kind == "conv":
        k = w.ndim - 2
        return "kernel", np.transpose(w, (*range(2, 2 + k), 1, 0))
    if kind == "linear":
        return "kernel", w.T
    raise ValueError(kind)


def _as_array(v) -> np.ndarray:
    """A leaf as numpy; a torch.bfloat16 leaf (no numpy dtype) widened to
    float32, which is exact."""
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = _as_array(v)
    return out


def _leaves(model: UNetModel):
    """(torch key prefix, flax path, leaf kind) of every parameterised leaf."""
    for tpath, fpath, kind in unet_layout(model):
        for tsuf, fsuf, leaf_kind in _KIND_LEAVES[kind]:
            yield (f"{tpath}.{tsuf}" if tsuf else tpath,
                   f"{fpath}/{fsuf}" if fsuf else fpath, leaf_kind)


def state_dict_from_jax(params: dict, model: UNetModel) -> dict[str, torch.Tensor]:
    """The JAX package's ``UNetModel`` params (nested dicts of numpy
    arrays) as a ``state_dict`` for ``model``. Raises on leftover keys."""
    flat = _flatten(params)
    out: dict[str, torch.Tensor] = {}
    consumed = set()
    for tfull, ffull, leaf_kind in _leaves(model):
        for fname in ("kernel", "bias", "scale"):
            fk = f"{ffull}/{fname}"
            if fk in flat:
                tname, arr = _f2t_leaf(leaf_kind, fname, flat[fk])
                out[f"{tfull}.{tname}"] = torch.from_numpy(np.array(arr))
                consumed.add(fk)
    leftovers = set(flat) - consumed
    if leftovers:
        raise KeyError(f"unconsumed JAX parameters: {sorted(leftovers)[:8]} ...")
    return out


def jax_params_from_state_dict(state_dict: dict, model: UNetModel) -> dict:
    """The inverse of :func:`state_dict_from_jax`: ``model``'s state_dict
    (tensors or arrays) as the JAX package's params tree of float32 numpy
    arrays, as ``bridge.torch_to_flax`` builds it. Raises on a missing key
    (the skip 1×1 conv is optional) and on leftover keys."""
    sd = {k: _as_array(v) for k, v in state_dict.items()}
    tree: dict = {}
    consumed = set()
    for tfull, ffull, leaf_kind in _leaves(model):
        for tname in ("weight", "bias"):
            tk = f"{tfull}.{tname}"
            if tk not in sd:
                if tfull.endswith("skip_connection"):
                    continue
                raise KeyError(f"missing torch key {tk}")
            fname, arr = _t2f_leaf(leaf_kind, tname, sd[tk])
            node = tree
            for part in ffull.split("/"):
                node = node.setdefault(part, {})
            node[fname] = np.ascontiguousarray(arr, dtype=np.float32)
            consumed.add(tk)
    leftovers = set(sd) - consumed
    if leftovers:
        raise KeyError(f"unconsumed torch keys: {sorted(leftovers)[:8]} ...")
    return tree
