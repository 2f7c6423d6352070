"""Checkpoints in the JAX package's format (port of
``fast_cwdm_tpu/training/checkpoints.py`` with a synchronous writer).

A ``.ckpt`` is flax msgpack (``training/serialization.py``) of
``{"params": tree, "ema_params": (tree, ...), "step": n}``, with the config
as a JSON sidecar ``<path>.json``. Names follow the reference:
``{dataset}_{contr}_BEST_{sample_schedule}_{steps}.ckpt`` and the
step-stamped ``{dataset}_{contr}_{step:06d}_{schedule}_{steps}.ckpt``, with
a ``best_losses.txt`` ledger of ``{modality}:{loss}`` lines. Training
writes ``opt_best_{contr}.ckpt`` beside each BEST and
``opt_{dataset}_{contr}_{step:06d}_{schedule}_{steps}.ckpt`` beside each
step-stamped checkpoint: ``{"opt_state": optax's adamw tree}``.

Under ``FAST_CWDM_CKPT_BACKEND=orbax`` (:func:`checkpoint_ext`) every one
of these files is an Orbax checkpoint directory ``….orbax`` instead
(``training/orbax_io.py``), with its sidecar at ``<path>.json`` beside the
directory; a path ending in ``.orbax`` (or an Orbax directory) is read and
written in that format whatever the variable says.

Deviations from the JAX package: both formats describe themselves, so
loading takes no parameter template and any number of EMA shadows loads
(JAX probes 0-3), and an ``.orbax`` comes back in the ``.ckpt`` form
(sequences as maps keyed "0", "1", …; ``EmptyState`` as ``{}``); the
port's ``.orbax`` chunks are zstd frames of raw blocks, larger on disk than
Orbax's compressed ones; a background write goes through an
:class:`AsyncWriter` its caller owns (the JAX package keeps one per
process).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from glob import glob
from typing import Any

import numpy as np
import torch

from fast_cwdm_tpu_torch.training import orbax_io, serialization
from fast_cwdm_tpu_torch.training.orbax_io import is_orbax_checkpoint


def checkpoint_ext() -> str:
    """The active format: ``.orbax`` under ``FAST_CWDM_CKPT_BACKEND=orbax``,
    else ``.ckpt`` (the JAX package's rule)."""
    return ".orbax" if os.environ.get("FAST_CWDM_CKPT_BACKEND") == "orbax" else ".ckpt"


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


def _to_host(tree, copy: bool = False):
    """The tree as the JAX package's writer stores it (its ``jax.tree.map``
    sorts dict keys and makes every leaf an array, a Python ``step`` a 0-d
    one); torch tensors move to the CPU. ``copy`` makes every leaf a copy
    of its own (a CPU tensor's ``.cpu()`` is the tensor itself), for a
    write that outlives the caller's next in-place update."""
    if isinstance(tree, dict):
        return {k: _to_host(tree[k], copy) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v, copy) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.cpu().clone() if copy and t.device.type == "cpu" else t.cpu()
    return np.array(tree) if copy else np.asarray(tree)


class AsyncWriter:
    """One checkpoint write in flight on a background thread: the caller
    copies its tensors to the host (they may change in place right after),
    serialisation and disk IO overlap the next steps. A failed write raises
    on the next :meth:`wait` or :meth:`submit`."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def submit(self, fn, *args) -> None:
        self.wait()

        def run():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 — raised by the next wait
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True, name="ckpt-writer")
        self._thread.start()


def _write_blob(path: str, host_payload, config: dict[str, Any] | None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if is_orbax_checkpoint(path):
        orbax_io.save(path, host_payload)
    else:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.writelines(serialization.serialize_parts(host_payload))
        os.replace(tmp, path)
    if config is not None:
        with open(path + ".json", "w") as f:
            json.dump(config, f, indent=2, default=str)


def save_checkpoint(path: str, payload: dict[str, Any],
                    config: dict[str, Any] | None = None, *,
                    writer: AsyncWriter | None = None) -> None:
    """msgpack-serialize a tree of dicts, lists, tuples, scalars, numpy
    arrays and torch tensors (+ the config sidecar), with the bytes the
    JAX package's ``save_checkpoint`` writes for the same tree (written to
    ``<path>.tmp``, then renamed); an ``.orbax`` path is written as an
    Orbax directory (:func:`orbax_io.save`). Synchronous, unless ``writer``
    is given: then the host copy is made here and the write runs on the
    writer's thread (after the write before it)."""
    if writer is not None:
        writer.submit(_write_blob, path, _to_host(payload, copy=True), config)
    else:
        _write_blob(path, _to_host(payload), config)


def load_checkpoint(path: str) -> dict[str, Any]:
    """The stored tree: dicts with string keys (a stored tuple comes back
    keyed ``"0"``, ``"1"``, …), numpy arrays, scalars; the same for an
    ``.ckpt`` file and an ``.orbax`` directory of the same payload."""
    if is_orbax_checkpoint(path):
        return orbax_io.load(path)
    with open(path, "rb") as f:
        blob = f.read()
    return serialization.msgpack_restore(blob)


def load_with_ema_probe(path: str) -> dict[str, Any]:
    """Load a ``{params, ema_params, step}`` checkpoint with any number of
    EMA shadows: ``ema_params`` comes back as a tuple. A missing file or
    ``.orbax`` directory raises as itself (``FileNotFoundError``); a
    truncated, corrupt or differently laid out one raises ``ValueError``
    ("could not deserialize … incompatible checkpoint layout"), as the JAX
    package's probe does."""
    try:
        state = load_checkpoint(path)  # OSError passes through
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
    ext = checkpoint_ext() if ext is None else ext
    return f"{dataset}_{contr}_BEST_{sample_schedule}_{diffusion_steps}{ext}"


def step_checkpoint_name(contr: str, step: int, sample_schedule: str, diffusion_steps: int,
                         dataset: str = "brats", ext: str | None = None) -> str:
    ext = checkpoint_ext() if ext is None else ext
    return f"{dataset}_{contr}_{step:06d}_{sample_schedule}_{diffusion_steps}{ext}"


def opt_checkpoint_name(contr: str, step: int, sample_schedule: str, diffusion_steps: int,
                        dataset: str = "brats", ext: str | None = None) -> str:
    """The optimizer blob paired with a step-stamped checkpoint, qualified
    by dataset, modality, schedule and steps as the JAX package names it
    (runs share one checkpoint_dir)."""
    ext = checkpoint_ext() if ext is None else ext
    return f"opt_{dataset}_{contr}_{step:06d}_{sample_schedule}_{diffusion_steps}{ext}"


def _remove(path: str) -> bool:
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
        return True
    if os.path.exists(path):
        os.remove(path)
        return True
    return False


def prune_step_checkpoints(ckpt_dir: str, contr: str, keep_step: int, sample_schedule: str,
                           diffusion_steps: int, dataset: str = "brats") -> list[str]:
    """Delete this run's (dataset, contr, schedule, steps) step-stamped model
    and optimizer blobs older than ``keep_step``; BEST checkpoints and
    other runs' files stay. Returns the removed paths."""
    removed: list[str] = []
    run_tag = f"_{sample_schedule}_{diffusion_steps}"
    for stem in (os.path.join(ckpt_dir, f"{dataset}_{contr}_*{run_tag}"),
                 os.path.join(ckpt_dir, f"opt_{dataset}_{contr}_*{run_tag}")):
        for p in glob(stem + ".ckpt") + glob(stem + ".orbax"):
            base = os.path.basename(p)
            m = re.search(r"_(\d{6,})(?:_|\.)", base)
            if "_BEST_" in base or not m or int(m.group(1)) >= keep_step:
                continue
            removed += [q for q in (p, p + ".json") if _remove(q)]
    return removed


def save_if_best(ckpt_dir: str, contr: str, loss: float, payload: dict[str, Any],
                 opt_payload: dict[str, Any] | None, *, sample_schedule: str,
                 diffusion_steps: int, dataset: str = "brats",
                 config: dict[str, Any] | None = None,
                 writer: AsyncWriter | None = None) -> bool:
    """Keep one best checkpoint per modality: when ``loss`` is finite and
    below the ledger's (or the ledger has none, or a non-finite one), write
    ``opt_best_{contr}`` (removing its sibling in the other format) and the
    BEST checkpoint with its sidecar, both in the active format,
    then delete the previous BEST and record the loss, in that order, so a
    failed write loses neither the old best nor the ledger. With
    ``writer`` the tensors are copied to the host here and the rest runs
    on its thread (the write before it finishes first, so the ledger read
    here is current). Returns True if saved."""
    if writer is not None:
        writer.wait()
    if not np.isfinite(loss):
        return False  # a NaN would pass an inverted guard and poison the ledger
    best = load_best_losses(ckpt_dir)
    prev = best.get(contr)
    if prev is not None and np.isfinite(prev) and not (loss < prev):
        return False
    name = best_checkpoint_name(contr, sample_schedule, diffusion_steps, dataset)
    new_main = os.path.abspath(os.path.join(ckpt_dir, name))
    stem = os.path.join(ckpt_dir, f"{dataset}_{contr}_BEST_*")
    old_files = [old for old in glob(stem + ".ckpt") + glob(stem + ".orbax")
                 if os.path.abspath(old) != new_main]
    copy = writer is not None
    host_payload = _to_host(payload, copy)
    host_opt = _to_host(opt_payload, copy) if opt_payload is not None else None

    ext = checkpoint_ext()
    other = ".ckpt" if ext == ".orbax" else ".orbax"

    def job():
        if host_opt is not None:
            _write_blob(os.path.join(ckpt_dir, f"opt_best_{contr}{ext}"), host_opt, None)
            # a sibling from before a backend switch would pair new params
            # with stale Adam moments on resume
            _remove(os.path.join(ckpt_dir, f"opt_best_{contr}{other}"))
        _write_blob(new_main, host_payload, config)
        for old in old_files:
            _remove(old)
            _remove(old + ".json")
        cur = load_best_losses(ckpt_dir)
        cur[contr] = float(loss)
        save_best_losses(ckpt_dir, cur)

    if writer is not None:
        writer.submit(job)
    else:
        job()
    return True


def get_blob_logdir() -> str:
    """Checkpoint root: ``$DIFFUSION_BLOB_LOGDIR`` or ``./checkpoints``."""
    return os.environ.get("DIFFUSION_BLOB_LOGDIR", "checkpoints")


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
