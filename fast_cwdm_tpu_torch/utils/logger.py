"""Key-value logger (port of ``fast_cwdm_tpu/utils/logger.py``, the
reference's OpenAI-baselines logger API).

``configure(dir, format_strs)``, ``log``, ``logkv``, ``logkv_mean``,
``dumpkvs``, ``log_images``, ``profile_kv``. Sinks: human-readable stdout
and ``log.txt``, ``progress.csv``, ``progress.json``, TensorBoard
(``torch.utils.tensorboard``) and wandb, the last two only where they
import. ``OPENAI_LOGDIR`` and ``OPENAI_LOG_FORMAT`` choose the directory
and the sinks.
"""

from __future__ import annotations

import contextlib
import csv as _csv
import datetime
import json
import os
import os.path as osp
import tempfile
import time
from collections import defaultdict

DEBUG, INFO, WARN, ERROR = 10, 20, 30, 40


class HumanOutput:
    def __init__(self, path_or_stream):
        if isinstance(path_or_stream, str):
            self.file = open(path_or_stream, "at")
            self.own = True
        else:
            self.file = path_or_stream
            self.own = False

    def writekvs(self, kvs):
        def fmt(v):
            return f"{v:<10.5g}" if hasattr(v, "__float__") else str(v)

        items = sorted(kvs.items())
        if not items:
            return
        width_k = max(len(k) for k, _ in items)
        width_v = max(len(fmt(v)) for _, v in items)
        dashes = "-" * (width_k + width_v + 7)
        lines = [dashes]
        for k, v in items:
            lines.append(f"| {k:<{width_k}} | {fmt(v):<{width_v}} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    def writeseq(self, seq):
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self):
        if self.own:
            self.file.close()


class JSONOutput:
    def __init__(self, path):
        self.file = open(path, "at")

    def writekvs(self, kvs):
        self.file.write(
            json.dumps({k: float(v) if hasattr(v, "__float__") else v
                        for k, v in kvs.items()})
            + "\n"
        )
        self.file.flush()

    def writeseq(self, seq):
        pass

    def close(self):
        self.file.close()


class CSVOutput:
    def __init__(self, path):
        self.path = path
        self.keys: list[str] = []

    def writekvs(self, kvs):
        extra = sorted(set(kvs) - set(self.keys))
        if extra:
            self.keys += extra
            rows = []
            if osp.exists(self.path):
                with open(self.path) as f:
                    rows = list(_csv.DictReader(f))
            # a pre-existing file (resumed run) may carry columns the new
            # run hasn't produced yet — keep them, or DictWriter raises on
            # the old rows and kills training at its first log dump
            for r in rows:
                for k in r:
                    if k not in self.keys:
                        self.keys.append(k)
            with open(self.path, "w", newline="") as f:
                w = _csv.DictWriter(f, fieldnames=self.keys)
                w.writeheader()
                for r in rows:
                    w.writerow(r)
        with open(self.path, "a", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=self.keys)
            w.writerow({k: kvs.get(k, "") for k in self.keys})

    def writeseq(self, seq):
        pass

    def close(self):
        pass


class TensorBoardOutput:
    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(logdir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), step)
        self.step = step + 1
        self.writer.flush()

    def writeseq(self, seq):
        pass

    def close(self):
        self.writer.close()


class WandbOutput:
    """Weights & Biases sink: project and entity from $WANDB_PROJECT /
    $WANDB_ENTITY; skipped where wandb does not import."""

    def __init__(self):
        import wandb  # only where installed

        self.wandb = wandb
        if wandb.run is None:
            wandb.init(
                project=os.environ.get("WANDB_PROJECT", "fast-cwdm"),
                entity=os.environ.get("WANDB_ENTITY"),
            )

    def writekvs(self, kvs):
        # pass the training step explicitly when the dump carries one:
        # mixing auto-step scalars with explicit-step image panels would
        # corrupt wandb's internal step axis (points land at x=1..k then
        # jump to the image step)
        step = kvs.get("step")
        self.wandb.log(
            {k: float(v) for k, v in kvs.items() if hasattr(v, "__float__")},
            step=int(step) if step is not None else None,
        )

    def writeimages(self, images, step):
        """Image panels (x0, subband and source mid-planes) as `wandb.Image`."""
        self.wandb.log(
            {k: self.wandb.Image(v) for k, v in images.items()}, step=step
        )

    def writeseq(self, seq):
        pass

    def close(self):
        pass


def make_output(fmt: str, logdir: str):
    if fmt == "stdout":
        import sys

        return HumanOutput(sys.stdout)
    if fmt == "log":
        return HumanOutput(osp.join(logdir, "log.txt"))
    if fmt == "json":
        return JSONOutput(osp.join(logdir, "progress.json"))
    if fmt == "csv":
        return CSVOutput(osp.join(logdir, "progress.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutput(osp.join(logdir, "tb"))
    if fmt == "wandb":
        return WandbOutput()
    raise ValueError(f"Unknown format {fmt}")


class Logger:
    CURRENT: "Logger | None" = None

    def __init__(self, logdir: str, outputs):
        self.logdir = logdir
        self.outputs = outputs
        self.name2val: dict = defaultdict(float)
        self.name2cnt: dict = defaultdict(int)
        self.level = INFO

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        """Running mean across calls within one dump window."""
        old, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = old * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        out = dict(self.name2val)
        for o in self.outputs:
            o.writekvs(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level=INFO):
        if level >= self.level:
            for o in self.outputs:
                o.writeseq(args)

    def close(self):
        for o in self.outputs:
            o.close()


def configure(logdir: str | None = None, format_strs=None) -> Logger:
    """Open the sinks in ``logdir`` ($OPENAI_LOGDIR, else a new directory
    under the temp dir); ``format_strs`` ($OPENAI_LOG_FORMAT, else
    stdout,log,csv). A sink that cannot open is skipped with a message."""
    if logdir is None:
        logdir = os.environ.get("OPENAI_LOGDIR")
    if logdir is None:
        logdir = osp.join(
            tempfile.gettempdir(),
            datetime.datetime.now().strftime("fast-cwdm-torch-%Y-%m-%d-%H-%M-%S-%f"),
        )
    os.makedirs(logdir, exist_ok=True)
    if format_strs is None:
        format_strs = os.environ.get(
            "OPENAI_LOG_FORMAT", "stdout,log,csv"
        ).split(",")
    outputs = []
    for f in filter(None, format_strs):
        try:
            outputs.append(make_output(f, logdir))
        except Exception as e:  # e.g. tensorboard missing
            print(f"[logger] skipping sink {f}: {e}")
    Logger.CURRENT = Logger(logdir, outputs)
    return Logger.CURRENT


def _get() -> Logger:
    if Logger.CURRENT is None:
        configure()
    return Logger.CURRENT


def get_dir() -> str:
    return _get().logdir


def logkv(key, val):
    _get().logkv(key, val)


def logkv_mean(key, val):
    _get().logkv_mean(key, val)


def dumpkvs():
    return _get().dumpkvs()


def log(*args, **kwargs):
    _get().log(*args, **kwargs)


def log_images(images: dict, step: int) -> None:
    """Write 2D arrays as images to every image-capable sink (TensorBoard,
    wandb)."""
    for o in _get().outputs:
        if isinstance(o, TensorBoardOutput):
            for k, v in images.items():
                o.writer.add_image(k, v[None], step)
            o.writer.flush()
        elif hasattr(o, "writeimages"):
            o.writeimages(images, step)


@contextlib.contextmanager
def profile_kv(name):
    """Accumulate wall-clock under ``wait_{name}``."""
    start = time.time()
    try:
        yield
    finally:
        _get().name2val[f"wait_{name}"] += time.time() - start


def profile(name):
    """Decorator form of :func:`profile_kv`."""

    def decorator(fn):
        def wrapped(*args, **kwargs):
            with profile_kv(name):
                return fn(*args, **kwargs)

        return wrapped

    return decorator


def visualize(img):
    """Min-max normalise a 2-D panel to [0, 1] for image logging."""
    import numpy as np

    img = np.asarray(img)
    lo, hi = img.min(), img.max()
    if hi == lo:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)
