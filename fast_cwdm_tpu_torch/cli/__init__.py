"""Synthesis plumbing and the entry points: sample, complete_dataset,
sample_auto, convert_checkpoint, train, drop_modality,
prepare_nnunet_dataset, evaluate_synthesis.

With ``FAST_CWDM_LAUNCH_COUNTS=<file>`` in its environment, a process
that imports them appends one JSON line to ``<file>`` when it exits: its
argv, every kernel's launch count (``ops.launch_counts()``) and its CUDA
graph captures and replays. A launcher (``run.sh``) can then tell which
kernels its child processes ran.
"""

from __future__ import annotations

import atexit
import json
import os
import sys


def _dump_launch_counts(path: str) -> None:
    from fast_cwdm_tpu_torch import ops

    graph = sys.modules.get("fast_cwdm_tpu_torch.diffusion.graph")
    rec = {"argv": sys.argv, "launches": ops.launch_counts(),
           "graph": dict(graph.counts) if graph else None}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


if os.environ.get("FAST_CWDM_LAUNCH_COUNTS"):
    atexit.register(_dump_launch_counts, os.environ["FAST_CWDM_LAUNCH_COUNTS"])
