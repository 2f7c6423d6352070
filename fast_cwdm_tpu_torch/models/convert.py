"""JAX parameter tree ↔ the port's ``state_dict``.

The port's own copy of the layout walk of the JAX package's
``training/bridge.py`` (``unet_layout``, ``encoder_layout``,
``wunet_layout``, ``_f2t_leaf``/``_t2f_leaf``, ``flax_to_torch``/
``torch_to_flax``, ``_check_ref_compat``), for every model the port
implements:

* flax Conv ``kernel`` (*k, I, O) → torch ``weight`` (O, I, *k);
* Dense ``kernel`` (I, O) → ``weight`` (O, I); attention ``qkv`` and
  ``proj_out`` Dense → the reference's 1×1 ``Conv1d`` (O, I, 1);
* GroupNorm ``scale``/``bias`` → ``weight``/``bias``; Embed
  ``embedding`` → ``weight``.

The WavUNet's reference layout registers the previous decoder block again
in every upsample block: those torch keys are aliases of one JAX leaf,
written by :func:`state_dict_from_jax` and, where present, checked equal
to their primary by :func:`jax_params_from_state_dict` (``ValueError``
otherwise). ``SuperResModel``'s JAX parameters sit under ``unet/``.

The parameter tree is nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``, or a ``.ckpt`` read by
``training/checkpoints.py``); nothing of JAX is imported here.
"""

from __future__ import annotations

import warnings
from typing import Iterator

import numpy as np
import torch

from fast_cwdm_tpu_torch.models.unet import EncoderUNetModel, SuperResModel, UNetModel
from fast_cwdm_tpu_torch.models.wunet import WavUNetModel

# per module kind: (torch suffix, flax suffix, leaf kind)
_KIND_LEAVES = {
    "conv": [("", "", "conv")],
    "linear": [("", "", "linear")],
    "embed": [("", "", "embed")],
    "norm": [("", "", "norm")],
    "downsample": [("op", "op", "conv")],
    "upsample": [("conv", "conv", "conv")],
    "res": [
        ("in_layers.0", "in_norm", "norm"),
        ("in_layers.2", "in_conv", "conv"),
        ("emb_layers.1", "emb_proj", "linear"),
        ("out_layers.0", "out_norm", "norm"),
        ("out_layers.3", "out_conv", "conv"),
        ("skip_connection", "skip", "conv_optional"),
    ],
    "attn": [
        ("norm", "norm", "norm"),
        ("qkv", "qkv", "conv1d_dense"),
        ("proj_out", "proj_out", "conv1d_dense"),
    ],
    "wavedown": [("conv", "conv", "conv")],
}


def unet_layout(model: UNetModel) -> Iterator[tuple[str, str, str]]:
    """(torch module path, flax module name, kind) for every parameterised
    module, replaying the UNet's construction bookkeeping."""
    yield "time_embed.0", "time_embed_0", "linear"
    yield "time_embed.2", "time_embed_2", "linear"
    if model.num_classes is not None:
        yield "label_emb", "label_emb", "embed"
    yield "input_blocks.0.0", "input_conv", "conv"
    nrb = model.num_res_blocks
    attn = model.attention_resolutions
    resample = "res" if model.resblock_updown else ("downsample" if model.conv_resample else None)
    tidx, bidx, ds = 1, 0, 1
    for level in range(len(model.channel_mult)):
        for _ in range(nrb):
            yield f"input_blocks.{tidx}.0", f"in_{bidx}_res", "res"
            if ds in attn:
                yield f"input_blocks.{tidx}.1", f"in_{bidx}_attn", "attn"
            tidx += 1
            bidx += 1
        if level != len(model.channel_mult) - 1:
            # conv_resample=False: an avg-pool downsample, no parameters
            if resample:
                yield f"input_blocks.{tidx}.0", f"in_{bidx}_down", resample
            tidx += 1
            bidx += 1
            ds *= 2
    yield "middle_block.0", "mid_res0", "res"
    if model.bottleneck_attention:
        yield "middle_block.1", "mid_attn", "attn"
    yield f"middle_block.{2 if model.bottleneck_attention else 1}", "mid_res1", "res"
    upsample = "res" if model.resblock_updown else ("upsample" if model.conv_resample else None)
    bidx = 0
    for level in reversed(range(len(model.channel_mult))):
        for i in range(nrb + 1):
            yield f"output_blocks.{bidx}.0", f"out_{bidx}_res", "res"
            sub = 1
            if ds in attn:
                yield f"output_blocks.{bidx}.1", f"out_{bidx}_attn", "attn"
                sub = 2
            if level and i == nrb:
                if upsample:
                    yield f"output_blocks.{bidx}.{sub}", f"out_{bidx}_up", upsample
                ds //= 2
            bidx += 1
    yield "out.0", "out_norm", "norm"
    yield "out.2", "out_conv", "conv"


def encoder_layout(model: EncoderUNetModel) -> Iterator[tuple[str, str, str]]:
    """The encoder's walk (JAX ``bridge.py:92``). Only the ``adaptive``
    head has a reference layout: the reference's ``spatial`` and
    ``spatial_v2`` heads are shape-incompatible dead code, so the walk
    raises ``NotImplementedError`` at the head of any other pool."""
    yield "time_embed.0", "time_embed_0", "linear"
    yield "time_embed.2", "time_embed_2", "linear"
    yield "input_blocks.0.0", "input_conv", "conv"
    resample = "res" if model.resblock_updown else ("downsample" if model.conv_resample else None)
    tidx, bidx, ds = 1, 0, 1
    for level in range(len(model.channel_mult)):
        for _ in range(model.num_res_blocks):
            yield f"input_blocks.{tidx}.0", f"in_{bidx}_res", "res"
            if ds in model.attention_resolutions:
                yield f"input_blocks.{tidx}.1", f"in_{bidx}_attn", "attn"
            tidx += 1
            bidx += 1
        if level != len(model.channel_mult) - 1:
            if resample:
                yield f"input_blocks.{tidx}.0", f"in_{bidx}_down", resample
            tidx += 1
            bidx += 1
            ds *= 2
    yield "middle_block.0", "mid_res0", "res"
    yield "middle_block.1", "mid_attn", "attn"
    yield "middle_block.2", "mid_res1", "res"
    if model.pool != "adaptive":
        raise NotImplementedError(
            f"the reference layout has pool='adaptive' only (got {model.pool!r}; the "
            "reference's spatial/spatial_v2 heads are shape-incompatible dead code)")
    yield "out.0", "out_norm", "norm"
    yield "out.3", "out_conv", "conv"


def wunet_layout(model: WavUNetModel) -> Iterator[tuple[str, str, str]]:
    """The WavUNet's walk (JAX ``bridge.py:139-218``). Kinds prefixed
    ``alias:`` are the reference decoder's second registration of the
    previous block: the same JAX leaves under other torch keys."""
    if not model.resblock_updown:
        raise NotImplementedError(
            "the reference layout has resblock_updown=True wunets only (the reference's "
            "standalone wavelet Down/Upsample path is dead code, `wunet.py:110-124`)")
    if model.num_res_blocks < 1:
        raise NotImplementedError("the wunet layout needs num_res_blocks >= 1")
    yield "time_embed.0", "time_embed_0", "linear"
    yield "time_embed.2", "time_embed_2", "linear"
    if model.num_classes is not None:
        yield "label_emb", "label_emb", "embed"
    yield "input_blocks.0.0", "input_conv", "conv"
    nrb = model.num_res_blocks
    attn = model.attention_resolutions
    tidx, bidx, ds = 1, 0, 1
    for level in range(len(model.channel_mult)):
        for _ in range(nrb):
            yield f"input_blocks.{tidx}.0", f"in_{bidx}_res", "res"
            if ds in attn:
                yield f"input_blocks.{tidx}.1", f"in_{bidx}_attn", "attn"
            tidx += 1
            bidx += 1
        yield f"input_blocks.{tidx}.0", f"in_{bidx}_down", "res"
        tidx += 1
        bidx += 1
        if model.progressive_input == "residual":
            yield f"input_blocks.{tidx}.0", f"pyramid_{level}", "wavedown"
        tidx += 1
        ds *= 2
    yield "middle_block.0", "mid_res0", "res"
    if model.bottleneck_attention:
        yield "middle_block.1", "mid_attn", "attn"
    yield f"middle_block.{2 if model.bottleneck_attention else 1}", "mid_res1", "res"
    bidx = 0
    for _ in model.channel_mult:
        for i in range(nrb + 1):
            if i != nrb:
                yield f"output_blocks.{bidx}.0", f"out_{bidx}_res", "res"
                if ds in attn:
                    yield f"output_blocks.{bidx}.1", f"out_{bidx}_attn", "attn"
            else:
                yield f"output_blocks.{bidx}.0", f"out_{bidx - 1}_res", "alias:res"
                sub = 1
                if ds in attn:
                    yield f"output_blocks.{bidx}.1", f"out_{bidx - 1}_attn", "alias:attn"
                    sub = 2
                yield f"output_blocks.{bidx}.{sub}", f"out_{bidx}_up", "res"
                ds //= 2
            bidx += 1
    for i in range(nrb):
        yield f"out_res.{i}.0", f"out_res_{i}", "res"
    yield "out.0", "out_norm", "norm"
    yield "out.2", "out_conv", "conv"


def layout(model) -> Iterator[tuple[str, str, str]]:
    """The walk of ``model``'s type."""
    if isinstance(model, WavUNetModel):
        return wunet_layout(model)
    if isinstance(model, EncoderUNetModel):
        return encoder_layout(model)
    if isinstance(model, SuperResModel):
        return ((t, f"unet/{f}", k) for t, f, k in unet_layout(model))
    if isinstance(model, UNetModel):
        return unet_layout(model)
    raise TypeError(f"no parameter layout for {type(model).__name__}")


def _f2t_leaf(kind: str, name: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    """flax leaf → (torch leaf name, array)."""
    if kind == "norm":
        return ("weight" if name == "scale" else "bias"), w
    if name == "bias":
        return "bias", w
    if kind in ("conv", "conv_optional"):
        k = w.ndim - 2
        return "weight", np.transpose(w, (k + 1, k, *range(k)))
    if kind == "conv1d_dense":
        return "weight", w.T[:, :, None]
    if kind == "linear":
        return "weight", w.T
    if kind == "embed":
        return "weight", w
    raise ValueError(kind)


def _t2f_leaf(kind: str, name: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    """torch leaf → (flax leaf name, array)."""
    if kind == "norm":
        return ("scale" if name == "weight" else "bias"), w
    if name == "bias":
        return "bias", w
    if kind in ("conv", "conv_optional"):
        k = w.ndim - 2
        return "kernel", np.transpose(w, (*range(2, 2 + k), 1, 0))
    if kind == "conv1d_dense":
        return "kernel", w[:, :, 0].T
    if kind == "linear":
        return "kernel", w.T
    if kind == "embed":
        return "embedding", w
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


def _leaves(model):
    """(torch key prefix, flax path, leaf kind, is an alias) of every
    parameterised leaf."""
    for tpath, fpath, kind in layout(model):
        alias = kind.startswith("alias:")
        for tsuf, fsuf, leaf_kind in _KIND_LEAVES[kind.removeprefix("alias:")]:
            yield (f"{tpath}.{tsuf}" if tsuf else tpath,
                   f"{fpath}/{fsuf}" if fsuf else fpath, leaf_kind, alias)


def state_dict_from_jax(params: dict, model) -> dict[str, torch.Tensor]:
    """The JAX package's params (nested dicts of numpy arrays) of the
    model of ``model``'s type as a ``state_dict`` for ``model``, alias keys
    included. Raises on leftover keys."""
    flat = _flatten(params)
    out: dict[str, torch.Tensor] = {}
    consumed = set()
    for tfull, ffull, leaf_kind, _alias in _leaves(model):
        for fname in ("kernel", "bias", "scale", "embedding"):
            fk = f"{ffull}/{fname}"
            if fk in flat:
                tname, arr = _f2t_leaf(leaf_kind, fname, flat[fk])
                out[f"{tfull}.{tname}"] = torch.from_numpy(np.array(arr))
                consumed.add(fk)
    leftovers = set(flat) - consumed
    if leftovers:
        raise KeyError(f"unconsumed JAX parameters: {sorted(leftovers)[:8]} ...")
    return out


def jax_params_from_state_dict(state_dict: dict, model) -> dict:
    """The inverse of :func:`state_dict_from_jax`: ``model``'s state_dict
    (tensors or arrays) as the JAX package's params tree of float32 numpy
    arrays, as ``bridge.torch_to_flax`` builds it. Raises ``KeyError`` on a
    missing key (the skip 1×1 conv is optional, and so is an alias key:
    ``named_parameters`` lists a shared tensor once) and on leftover keys,
    and ``ValueError`` where an alias key differs from its primary."""
    sd = {k: _as_array(v) for k, v in state_dict.items()}
    flat: dict[str, np.ndarray] = {}
    consumed = set()
    for tfull, ffull, leaf_kind, alias in _leaves(model):
        for tname in ("weight", "bias"):
            tk = f"{tfull}.{tname}"
            if tk not in sd:
                if alias or leaf_kind == "conv_optional" or (tname, leaf_kind) == ("bias", "embed"):
                    continue
                raise KeyError(f"missing torch key {tk}")
            fname, arr = _t2f_leaf(leaf_kind, tname, sd[tk])
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            fk = f"{ffull}/{fname}"
            if not alias:
                flat[fk] = arr
            elif not np.array_equal(flat[fk], arr):
                raise ValueError(f"aliased torch key {tk} disagrees with its primary ({fk}): "
                                 "not a reference-shaped wunet state_dict")
            consumed.add(tk)
    leftovers = set(sd) - consumed
    if leftovers:
        raise KeyError(f"unconsumed torch keys: {sorted(leftovers)[:8]} ...")
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def check_ref_compat(model, direction: str) -> None:
    """Reference WavUNet checkpoints were trained with the decoder's
    double run; carrying them to or from a ``ref_compat=False`` model
    loads cleanly but changes the forward. Warns (JAX ``bridge.py:398``)."""
    if isinstance(model, WavUNetModel) and not model.ref_compat:
        warnings.warn(
            f"{direction} a WavUNetModel with ref_compat=False: the reference decoder "
            "re-runs the previous ResBlock/Attention (`wunet.py:647-673`); reference-trained "
            "weights will produce different outputs on this model. Construct with "
            "ref_compat=True (the factory's default for use_freq=True) for "
            "reference-faithful forwards.",
            stacklevel=3,
        )
