"""Checkpoints in the JAX package's format (port of the reading side of
``fast_cwdm_tpu/training/checkpoints.py`` and its synchronous writer).

A ``.ckpt`` is flax msgpack (``training/serialization.py``) of
``{"params": tree, "ema_params": (tree, ...), "step": n}``, with the config
as a JSON sidecar ``<path>.json``. Names follow the reference:
``{dataset}_{contr}_BEST_{sample_schedule}_{steps}.ckpt`` and the
step-stamped ``{dataset}_{contr}_{step:06d}_{schedule}_{steps}.ckpt``, with
a ``best_losses.txt`` ledger of ``{modality}:{loss}`` lines.

Deviations from the JAX package: the format describes itself, so loading
takes no parameter template and any number of EMA shadows loads (JAX
probes 0-3); the port writes ``.ckpt`` only and refuses ``.orbax``
(discovery still finds ``.orbax`` directories, as JAX's does).
"""

from __future__ import annotations

import json
import os
import re
from glob import glob
from typing import Any

import numpy as np
import torch

from fast_cwdm_tpu_torch.training import serialization

ORBAX_REFUSAL = (
    "the port reads and writes the JAX package's default .ckpt backend only; "
    "convert an .orbax checkpoint with the JAX package (FAST_CWDM_CKPT_BACKEND "
    "unset writes .ckpt)"
)


# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------


def load_best_losses(ckpt_dir: str) -> dict[str, float]:
    path = os.path.join(ckpt_dir, "best_losses.txt")
    best: dict[str, float] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if ":" in line:
                    k, v = line.split(":", 1)
                    best[k.strip()] = float(v)
    return best


def save_best_losses(ckpt_dir: str, best: dict[str, float]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "best_losses.txt"), "w") as f:
        for k, v in sorted(best.items()):
            f.write(f"{k}:{v}\n")


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------


def is_orbax_checkpoint(path: str) -> bool:
    """``.orbax`` by name, or an Orbax checkpoint directory."""
    return path.endswith(".orbax") or (os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "_METADATA"))))


def _to_host(tree):
    """The tree as the JAX package's writer stores it (its ``jax.tree.map``
    sorts dict keys and makes every leaf an array, a Python ``step`` a 0-d
    one); torch tensors move to the CPU."""
    if isinstance(tree, dict):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return np.asarray(tree)


def save_checkpoint(path: str, payload: dict[str, Any],
                    config: dict[str, Any] | None = None) -> None:
    """msgpack-serialize a tree of dicts, lists, tuples, scalars, numpy
    arrays and torch tensors (+ the config sidecar), with the bytes the
    JAX package's ``save_checkpoint`` writes for the same tree.
    Synchronous: the file is complete (written to ``<path>.tmp``, then
    renamed) on return."""
    if is_orbax_checkpoint(path):
        raise NotImplementedError(f"{path}: {ORBAX_REFUSAL}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(serialization.serialize_parts(_to_host(payload)))
    os.replace(tmp, path)
    if config is not None:
        with open(path + ".json", "w") as f:
            json.dump(config, f, indent=2, default=str)


def load_checkpoint(path: str) -> dict[str, Any]:
    """The stored tree: dicts with string keys (a stored tuple comes back
    keyed ``"0"``, ``"1"``, …), numpy arrays, scalars."""
    if is_orbax_checkpoint(path):
        raise NotImplementedError(f"{path}: {ORBAX_REFUSAL}")
    with open(path, "rb") as f:
        blob = f.read()
    return serialization.msgpack_restore(blob)


def load_with_ema_probe(path: str) -> dict[str, Any]:
    """Load a ``{params, ema_params, step}`` checkpoint with any number of
    EMA shadows: ``ema_params`` comes back as a tuple. A missing file
    raises as itself; a truncated, corrupt or differently laid out one
    raises ``ValueError`` ("could not deserialize … incompatible checkpoint
    layout"), as the JAX package's probe does."""
    try:
        state = load_checkpoint(path)  # OSError and the .orbax refusal pass through
        ema = state["ema_params"]
        if not (isinstance(state["params"], dict) and isinstance(ema, dict)
                and list(ema) == [str(i) for i in range(len(ema))]
                and all(isinstance(v, dict) for v in ema.values())):
            raise ValueError("expected params and ema_params maps")
        return {"params": state["params"], "ema_params": tuple(ema.values()),
                "step": state["step"]}
    except (ValueError, TypeError, KeyError) as e:
        raise ValueError(
            f"could not deserialize {path} — incompatible checkpoint layout") from e


def load_checkpoint_config(path: str) -> dict[str, Any] | None:
    """The config stored beside a checkpoint (``<path>.json``), if any."""
    side = path + ".json"
    if os.path.exists(side):
        with open(side) as f:
            return json.load(f)
    return None


# ---------------------------------------------------------------------------
# Filename conventions
# ---------------------------------------------------------------------------


def best_checkpoint_name(contr: str, sample_schedule: str, diffusion_steps: int,
                         dataset: str = "brats", ext: str | None = None) -> str:
    return f"{dataset}_{contr}_BEST_{sample_schedule}_{diffusion_steps}{ext or '.ckpt'}"


def step_checkpoint_name(contr: str, step: int, sample_schedule: str, diffusion_steps: int,
                         dataset: str = "brats", ext: str | None = None) -> str:
    return f"{dataset}_{contr}_{step:06d}_{sample_schedule}_{diffusion_steps}{ext or '.ckpt'}"


def find_best_checkpoint(ckpt_dir: str, contr: str, dataset: str = "brats"):
    """The newest (by mtime) ``{dataset}_{contr}_BEST_*`` checkpoint of
    either backend, as ``(path, sample_schedule, steps)``: from its sidecar,
    else from its name, else ``("direct", 1000)``; None when there is none."""
    stem = os.path.join(ckpt_dir, f"{dataset}_{contr}_BEST_*")
    matches = sorted(glob(stem + ".ckpt") + glob(stem + ".orbax"), key=os.path.getmtime)
    if not matches:
        return None
    path = matches[-1]
    cfg = load_checkpoint_config(path)
    if cfg and "sample_schedule" in cfg:
        return path, cfg["sample_schedule"], int(cfg["diffusion_steps"])
    m = re.match(rf".*{re.escape(dataset)}_{re.escape(contr)}"
                 r"_BEST_(\w+?)_(\d+)\.(?:ckpt|orbax)$", path)
    if m:
        return path, m.group(1), int(m.group(2))
    return path, "direct", 1000


def parse_resume_step_from_filename(filename: str) -> int:
    """The zero-padded step of a step-stamped name
    (``brats_{contr}_{step:06d}_{schedule}_{steps}``, 6 digits or more) or
    of a legacy ``opt{step:06d}``; 0 for BEST and unknown names."""
    stem = os.path.basename(filename).rsplit(".", 1)[0]
    m = re.search(r"_(\d{6,})_", stem)
    if m:
        return int(m.group(1))
    m = re.fullmatch(r"opt(\d{6,})", stem)
    if m:
        return int(m.group(1))
    return 0
