"""Orbax checkpoints (``StandardCheckpointer`` directories) without Orbax.

Port of ``fast_cwdm_tpu/training/orbax_io.py``, the JAX package's
``.orbax`` backend (``FAST_CWDM_CKPT_BACKEND=orbax``). A checkpoint written
by Orbax 0.11 with its defaults is a directory holding

* ``_CHECKPOINT_METADATA``: JSON, the handler's name and commit times;
* ``_METADATA``: JSON, ``tree_metadata`` with one entry per leaf keyed by
  the repr of its key path: ``key_metadata`` (each key with ``key_type`` 2
  for a mapping key or attribute, 1 for a sequence index) and
  ``value_metadata`` (``value_type`` ``np.ndarray``, ``jax.Array`` or
  ``scalar`` for an array; ``None``, ``Tuple``, ``List`` or ``Dict`` with
  ``skip_deserialize`` for an empty node such as optax's ``EmptyState``),
  and ``use_ocdbt: true``, ``use_zarr3: false``;
* an OCDBT database (``training/ocdbt.py``) in which leaf ``a.b.c`` is a
  zarr v2 array: ``a.b.c/.zarray`` (JSON: shape, chunks, dtype such as
  ``<f4``, ``<i8`` or ``bfloat16``, ``order`` C, a ``zstd`` compressor) and
  its chunks ``a.b.c/0.0…``, each one zstd frame (``training/zstd.py``).
  Orbax writes a host array as one chunk.

:func:`load` returns the tree in the ``.ckpt`` codec's form
(``training/serialization.py``), not Orbax's: sequences come back as maps
keyed ``"0"``, ``"1"``, …, an empty node (``EmptyState``, an empty EMA
tuple) as ``{}``, a ``bfloat16`` array as a ``torch.bfloat16`` tensor, a
scalar as a 0-d array. So every caller of ``load_checkpoint`` takes both
formats alike.

:func:`save` writes what the JAX package's ``orbax_io.save`` writes for a
host payload (every leaf an ``np.ndarray``; a tuple or list is a sequence;
an empty tuple is ``Tuple``, an empty list ``List`` and an empty map
``None``, the ``.ckpt`` form of ``EmptyState``), except that each chunk is
a zstd frame of raw blocks (``zstd.compress``): the port's ``.orbax`` is
larger on disk than Orbax's. It writes into a temporary directory beside
``path`` and renames it at the end, replacing an existing ``path``, as
Orbax commits with ``force=True``. A commit is durable when :func:`save`
returns: every file of the directory and every directory entry it made
(``d/``, the temporary directory, the rename in ``path``'s parent) is
fsynced before the rename or after it. A crash before the rename leaves
the old ``path`` (or none) and a temporary directory; a crash between
the removal of an old ``path`` and the rename leaves neither, as Orbax's
own ``force=True`` does.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from fast_cwdm_tpu_torch.training import ocdbt, zstd

HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
_EMPTY_TYPES = ("None", "Tuple", "List", "Dict")
_KEY_DICT, _KEY_SEQUENCE = 2, 1


def available() -> bool:
    """The port always has this backend (it needs no package)."""
    return True


def is_orbax_checkpoint(path: str) -> bool:
    """``.orbax`` by name, or an Orbax checkpoint directory."""
    return path.endswith(".orbax") or (os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "_METADATA"))))


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _leaves(tree, keys=(), types=()):
    """``(keys, key_types, leaf)`` in pytree order (maps by sorted key)."""
    if isinstance(tree, dict):
        if not tree:
            yield keys, types, "None"
        for k in sorted(tree):
            yield from _leaves(tree[k], keys + (str(k),), types + (_KEY_DICT,))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            yield keys, types, "Tuple" if isinstance(tree, tuple) else "List"
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + (str(i),), types + (_KEY_SEQUENCE,))
    elif tree is None:
        yield keys, types, "None"
    else:
        yield keys, types, tree


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """The C-order bytes of a leaf as an array, and its zarr dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        leaf = t.numpy()
    a = np.asarray(leaf)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.kind not in "biufc":
        raise TypeError(f"cannot store a {a.dtype} leaf in an Orbax checkpoint")
    return a, a.dtype.str


def _zarray(shape, dtype: str) -> bytes:
    meta = {"chunks": list(shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def _write_durably(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def save(path: str, payload: dict[str, Any]) -> None:
    """Write ``payload`` (maps, tuples, lists, numpy arrays, torch tensors,
    scalars) as an Orbax checkpoint directory at ``path``."""
    path = os.path.abspath(path)
    init = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{init}"
    items: dict[str, bytes] = {}
    tree_meta: dict[str, Any] = {}
    for keys, types, leaf in _leaves(payload):
        key_meta = [{"key": k, "key_type": t} for k, t in zip(keys, types)]
        if isinstance(leaf, str):
            value_meta = {"value_type": leaf, "skip_deserialize": True}
        else:
            arr, dtype = _host_array(leaf)
            name = ".".join(keys)
            items[f"{name}/.zarray"] = _zarray(arr.shape, dtype)
            items[f"{name}/{'.'.join(['0'] * max(arr.ndim, 1))}"] = zstd.compress(arr.data)
            value_meta = {"value_type": "np.ndarray", "skip_deserialize": False}
        tree_meta[str(keys)] = {"key_metadata": key_meta, "value_metadata": value_meta}
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        ocdbt.write(tmp, items)
        meta = {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
        _write_durably(os.path.join(tmp, "_METADATA"), meta)
        _write_durably(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
        ocdbt.fsync_dir(tmp)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
        os.rename(tmp, path)
        ocdbt.fsync_dir(os.path.dirname(path))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _array_plan(db: ocdbt.Reader, name: str, where: str):
    """``(.zarray meta, chunk keys with their grid index)`` of one leaf."""
    try:
        meta = json.loads(bytes(db.read(f"{name}/.zarray")))
    except KeyError as e:
        raise ValueError(f"{where}: no zarr array {name!r}") from e
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{where}: {name}: unsupported zarr layout {meta}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: {name}: unsupported compressor {comp}")
    shape, chunks = meta["shape"], meta["chunks"]
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{where}: {name}: bad chunk shape {chunks} for {shape}")
    sep = meta.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    cells = list(np.ndindex(*grid)) if shape else [()]
    return meta, [(f"{name}/{sep.join(map(str, c)) if c else '0'}", c) for c in cells]


def _dtype(meta) -> np.dtype:
    try:
        return np.dtype(np.int16) if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"unknown zarr dtype {meta['dtype']!r}") from e


def load(path: str) -> dict[str, Any]:
    """The tree stored in the Orbax checkpoint directory ``path``, in the
    ``.ckpt`` codec's form. A missing directory raises
    ``FileNotFoundError``; anything that is not a readable checkpoint of
    this layout raises ``ValueError``."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no Orbax checkpoint directory at {path}")
    try:
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
        entries = meta["tree_metadata"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{path}: no readable _METADATA") from e
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT + zarr v2 checkpoints are supported")
    db = ocdbt.Reader(path)
    tree: dict[str, Any] = {}
    arrays = []  # (parent map, key, zarray meta, [(chunk key, grid index)])
    for entry in entries.values():
        try:
            keys = [str(k["key"]) for k in entry["key_metadata"]]
            vtype = entry["value_metadata"]["value_type"]
        except (KeyError, TypeError) as e:
            raise ValueError(f"{path}: malformed tree_metadata entry {entry}") from e
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(f"{path}: leaf and node share the key path {keys}")
        if vtype in _EMPTY_TYPES:
            if keys:
                node[keys[-1]] = {}
        elif vtype in _ARRAY_TYPES:
            arrays.append((node, keys[-1], *_array_plan(db, ".".join(keys), path)))
        else:
            raise ValueError(f"{path}: unknown value type {vtype!r} at {keys}")
    try:
        frames = [db.read(k) for *_, cells in arrays for k, _ in cells]
    except KeyError as e:
        raise ValueError(f"{path}: missing zarr chunk {e}") from e
    comp = [a[2].get("compressor") is not None for a in arrays for _ in a[3]]
    decoded = iter(zstd.decompress_many([f for f, c in zip(frames, comp) if c]))
    raw = iter(frames)
    for node, key, zmeta, cells in arrays:
        dt, shape, chunks = _dtype(zmeta), zmeta["shape"], zmeta["chunks"]
        parts = []
        for _, cell in cells:
            buf = next(raw)
            if zmeta.get("compressor") is not None:
                buf = next(decoded)
            if len(buf) != math.prod(chunks) * dt.itemsize:
                raise ValueError(f"{path}: chunk {cell} of {key!r} has {len(buf)} bytes")
            parts.append(np.frombuffer(buf, dt).reshape(chunks))
        if len(cells) == 1 and chunks == shape and isinstance(buf, np.ndarray):
            out = parts[0]  # one decoded chunk: the array itself (Orbax's case)
        else:
            out = np.empty(shape, dt)
            for part, (_, cell) in zip(parts, cells):
                sl = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(cell, chunks, shape))
                out[sl] = part[tuple(slice(0, x.stop - x.start) for x in sl)]
        node[key] = torch.from_numpy(out).view(torch.bfloat16) if zmeta["dtype"] == "bfloat16" else out
    return tree


def restore_any(path: str) -> dict[str, Any]:
    """:func:`load` (the JAX package's templateless restore; the port's
    load needs no template)."""
    return load(path)
