"""Single-card batch-2 training probe (port of ``scripts/probe_batch2.py``).

The reference's production config trains at batch 2 (``run.sh:146``
upstream). This probe records the card's answers at production shapes
(bf16, remat, AdamW lr 1e-5 annealed over 5,000 steps, one EMA rate
0.9999), through ``training/train.py::make_train_step``:

(a) batch 2 as 2×1 gradient accumulation (``accum_steps=2``, the
    ``--microbatch`` path);
(b) the TRUE batch-2 step, at remat-ALL (``remat_max_ds`` 0) and at the
    production default (ds <= 1), each tried on its own: a failure (out of
    memory, say) is recorded as the leg's row, not raised;
(c) the batch-1 step as the reference point.

Each leg gives its device ms per step (``utils/devtime``: CUDA events on
the card, its ``source``), the loss of its first step, the peak device memory, and the
kernel launches of its ``steps`` steps (the first, devtime's warm-up and
the timed ones). The batch is numpy
``default_rng(0)`` uniform volumes, as the JAX script's ``make_batch``.

    python -m fast_cwdm_tpu_torch.scripts.probe_batch2

``--device`` defaults to ``cuda``; without a GPU the run raises unless
``--device cpu`` is given (device times and memory are then 0;
``--quick`` runs a tiny model at an 8³ volume). Prints the rows as one JSON
list last; :func:`main` returns them.
"""

from __future__ import annotations

import argparse
import gc
import json
import traceback

import numpy as np

from fast_cwdm_tpu_torch.data.brats import MODALITIES

S = (224, 224, 160)  # image space (latent 112x112x80 after DWT)
QUICK_S = (8, 8, 8)
QUICK_MODEL = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    ap.add_argument("--quick", action="store_true",
                    help="a tiny model and volume: a harness check, not a measurement")
    ap.add_argument("--iters", type=int, default=3,
                    help="steps timed per leg (after one warm-up step)")
    return ap.parse_args(argv)


def build(remat_max_ds: int = 1, *, device, quick: bool = False):
    """(model, diffusion, optimizer, initial weights): the production UNet
    with ``use_checkpoint`` in bf16 (``remat_max_ds``: 0 remats every
    ResBlock, K only those at ds <= K; 1 is the production default), the
    linear 1000-step x0 process of i2i, and AdamW lr 1e-5 annealed over
    5,000 steps. The weights are the model's own initialisation from seed
    0, a copy kept so every leg starts from them."""
    import torch

    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from fast_cwdm_tpu_torch.scripts.probe_elementwise import seeded_model
    from fast_cwdm_tpu_torch.training.train import make_optimizer

    model = seeded_model(0, device, use_checkpoint=True, dtype=torch.bfloat16,
                         remat_max_ds=remat_max_ds, **(QUICK_MODEL if quick else {}))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    diffusion = GaussianDiffusion.named("linear", 1000, "direct", mode="i2i")
    tx = make_optimizer(1e-5, lr_anneal_steps=5000)
    return model, diffusion, tx, init


def make_batch(b: int, shape=S, device="cpu"):
    import torch

    rng = np.random.default_rng(0)
    return {m: torch.from_numpy(rng.random((b, *shape, 1), np.float32)).to(device)
            for m in MODALITIES}


def init_state(model, tx, init: dict):
    """The model back at its initial weights, and a fresh state (step 0,
    Adam's moments zero, one EMA shadow 0.9999)."""
    from fast_cwdm_tpu_torch.training.state import TrainState

    model.load_state_dict(init)
    return TrainState.create(model, tx, ema_rates=(0.9999,))


def time_step(label: str, model, diffusion, tx, init: dict, b: int, accum: int = 1, *,
              shape=S, iters: int = 3) -> dict:
    import torch

    from fast_cwdm_tpu_torch.ops import launch_counts, launches_since
    from fast_cwdm_tpu_torch.training.train import StepRNG, make_train_step
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    before = launch_counts()
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    step = make_train_step(model, diffusion, tx, contr="t1c", mode="i2i", accum_steps=accum)
    state = init_state(model, tx, init)
    batch = make_batch(b, shape, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"[{label}] first step ...", flush=True)
    state, metrics = step(state, batch, StepRNG.seeded(1, dev))
    loss = float(metrics["loss"])
    print(f"[{label}] first step OK, loss={loss:.5f}", flush=True)
    del state, metrics
    gc.collect()
    state2 = init_state(model, tx, init)
    # by CUDA events on the card: the profiler's trace of a step misses
    # some of K1's and K2's records there
    timed = devtime(step, state2, batch, StepRNG.seeded(1, dev), iters=iters, events=True)
    ms = timed["total_ms"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0
    print(f"[{label}] device time: {ms:.1f} ms/step, peak {peak:.2f} GB", flush=True)
    del state2
    gc.collect()
    return {"label": label, "ms_per_step": round(ms, 1), "loss": loss, "peak_gb": round(peak, 2),
            # the first step, devtime's warm-up, its timed steps, and as many
            # again where it re-timed them by CUDA events
            "steps": 2 + iters * (2 if timed.get("source") == "cuda_events" else 1),
            "launches": launches_since(before), "source": timed.get("source")}


def _release(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> list:
    import torch

    from fast_cwdm_tpu_torch import resolve_device

    a = parse_args(argv)
    dev = resolve_device(a.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    shape = QUICK_S if a.quick else S
    kw = dict(shape=shape, iters=a.iters)
    results = []

    model, diffusion, tx, init = build(device=dev, quick=a.quick)
    results.append(time_step("batch1", model, diffusion, tx, init, 1, **kw))
    results.append(time_step("batch2_accum", model, diffusion, tx, init, 2, 2, **kw))
    del model, init
    _release(dev)

    for remat, label in ((0, "batch2_true_remat_all"), (1, "batch2_true_remat_ds1")):
        try:
            m2, d2, tx2, init2 = build(remat_max_ds=remat, device=dev, quick=a.quick)
            results.append(time_step(label, m2, d2, tx2, init2, 2, **kw))
        except Exception as e:  # noqa: BLE001 — the outcome IS the datum
            print(f"[{label}] FAILED: {type(e).__name__}: {str(e)[:300]}")
            traceback.print_exc(limit=2)
            results.append({"label": label, "error": str(e)[:300]})
        finally:
            m2 = init2 = None
            _release(dev)

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
