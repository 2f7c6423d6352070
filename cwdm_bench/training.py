"""The driver of training mixes (``"kind": "training"``).

Optimizer steps of the program's ``training/train.py::make_train_step``
back to back, on seeded cases resident on the device (as ``--device_cache``
keeps them). Each step's feed, drawn on the device from a seed of the
step's own: the batch's cases, t uniform over the schedule and the
image-space noise. Set-up builds one train state and step, drives them
through the first ``check_steps`` steps (the reference follows those) and
hands the same objects to the window.

Compared with the reference (plain fp32, the same weights, cases, t and
noise): each checked step's loss; the first step's gradient as the
optimizer got it (AdamW's first moment after one step, divided by 1 − β1);
the parameters' change and the EMA shadow's change after the checked
steps. A gradient or a change is compared leaf by leaf by its norm, as the
gap between the program's norm and the reference's over the larger of the
reference's norm of that leaf and of the median leaf; the worst leaf
counts. Leaves whose first reference gradient is under a thousandth of the
median leaf's are left out of the changes (AdamW moves them by round-off).

Traffic keys: ``contr``, ``batch``, ``cases``, ``trace_items`` (steps in the
traced block), ``check_steps``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from cwdm_bench import harness, phantom
from cwdm_bench.reference import cwdm

TRACED = 2**41  # step index of the traced block


class Feed:
    """The case pool on the device and each step's batch, t and noise."""

    def __init__(self, run: harness.Run, n_steps: int):
        tr = run.traffic
        self.run, self.n_steps, self.batch = run, n_steps, int(tr["batch"])
        n = int(tr["cases"])
        self.pool = [phantom.make_case(harness.sub_seed(run.seed, "case", j),
                                       run.config["geometry"], run.device) for j in range(n)]
        order = np.random.default_rng(harness.sub_seed(run.seed, "order")).permutation(n)
        self.order = [int(k) for k in order]

    def __call__(self, i: int):
        picks = [self.pool[self.order[(i * self.batch + b) % len(self.pool)]]
                 for b in range(self.batch)]
        batch = (picks[0] if self.batch == 1 else
                 {m: torch.cat([p[m] for p in picks]) for m in picks[0]})
        g = torch.Generator(device=self.run.device).manual_seed(
            harness.sub_seed(self.run.seed, "step", i))
        t = torch.randint(0, self.n_steps, (self.batch,), generator=g, device=self.run.device)
        noise = torch.randn(batch[cwdm.MODALITIES[0]].shape, generator=g, device=self.run.device)
        return batch, t, noise


def model_config(cfg: dict) -> dict:
    """The model's flags for training: the configuration's model and its
    training section's routes."""
    routes = ("use_checkpoint", "fuse_gn_silu", "fuse_conv")
    return {**cfg["model"], **{k: v for k, v in cfg["training"].items() if k in routes}}


def _norms(tensors: dict) -> dict:
    return {k: torch.linalg.vector_norm(v.float()) for k, v in tensors.items()}


def _host(norms: dict) -> dict:
    return {k: float(v) for k, v in norms.items()}


def run(run: harness.Run) -> dict:
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.training import state as tstate
    from fast_cwdm_tpu_torch.training import train

    cfg, tr, dev = run.config, run.traffic, run.device
    run.part("import")
    if dev.type == "cuda":
        from fast_cwdm_tpu_torch.ops import _build

        _build.build()
    run.part("build")
    opt_cfg = cfg["training"]
    model_cfg = model_config(cfg)
    model, diffusion = harness.build_program(model_cfg, run.seed, dev)
    opt = train.make_optimizer(opt_cfg["lr"], weight_decay=opt_cfg["weight_decay"],
                               lr_anneal_steps=opt_cfg["lr_anneal_steps"])
    state = tstate.TrainState.create(model, opt, ema_rates=(opt_cfg["ema_rate"],))
    step = train.make_train_step(model, diffusion, opt, contr=tr["contr"])
    run.part("weights_and_state")
    feed = Feed(run, diffusion.num_timesteps)
    run.part("cases")

    def one(i: int) -> dict:
        """Step ``i`` of the run: its feed through the step, the state in place."""
        batch, t, noise = feed(i)
        return step(state, batch, t=t, noise_img=noise)[1]

    # the checked steps, through the window's own call and feed
    n_check = int(tr["check_steps"])
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    losses, grad1 = [], None
    before = ops.launch_counts()
    for i in range(n_check):
        metrics = one(i)
        losses.append(metrics["loss"])
        if i == 0:
            launched = ops.launches_since(before)
            grad1 = {k: torch.linalg.vector_norm(v) / (1.0 - opt.b1)
                     for k, v in state.opt_state["mu"].items()}
    change = _norms({k: p.detach() - p0[k] for k, p in state.params.items()})
    ema = _norms({k: e - p0[k] for k, e in state.ema_params[0].items()})
    program = {"loss": [float(v) for v in losses], "grad1": _host(grad1),
               "change": _host(change), "ema": _host(ema)}
    del p0
    run.part("checked_steps")
    setup_s = time.perf_counter() - run.t_start
    harness.log(setup_s=setup_s, setup=run.setup, launches_per_step=launched)

    bad = torch.zeros((), dtype=torch.int64, device=dev)
    harness.reset_peak(dev)
    ends = []
    with harness.HostLoad() as host:
        t0 = time.perf_counter()
        i = n_check
        while time.perf_counter() - t0 < run.seconds:
            metrics = one(i)
            bad += (~torch.isfinite(metrics["loss"])).to(torch.int64)
            i += 1
            ends.append(time.perf_counter())
        harness.sync(dev)
        window_s = time.perf_counter() - t0
    steps = i - n_check
    harness.log(window_host=host.summary, step_s_by_10s=harness.slice_rates(ends, t0))

    rec = {"config": cfg, "model": model_cfg, "traffic": tr, "setup_s": setup_s,
           "window_s": window_s, "items": steps, "batch": feed.batch,
           "forwards_per_item": 1, "latent": tuple(s // 2 for s in feed.pool[0]["t1n"].shape[1:4]),
           "trace": None, "spans": {}, "attempted": steps, "failed": int(bad)}
    if run.trace:
        from cwdm_bench import devtrace

        n = int(tr["trace_items"])

        def work(j: int) -> None:
            with torch.profiler.record_function("bench.step"):
                one(TRACED + j)

        summary = devtrace.traced(work, n, ops.launch_counts, ops.launches_since, dev,
                                  timers=harness.wavelet_timers(run))
        harness.log(trace_window_s=summary["window_s"], busy_s=summary["busy_s"],
                    records_missing=summary["records_missing"], launched=summary["launched"],
                    filled=summary["filled"])
        rec.update(trace=summary, trace_items=n)
    rec["device"] = harness.device_record(dev, 1)
    del state, step, model, opt, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(run, model_cfg, feed, n_check, "fp32")
    rec["readings"] = compare(program, ref)
    return rec


def reference_readings(run, model_cfg: dict, feed: Feed, n_steps: int, prec: str) -> dict:
    """The reference's losses, first gradient and changes over the first
    ``n_steps`` steps of the same feed, in ``prec``."""
    opt_cfg = run.config["training"]
    init = harness.draw_weights(cwdm.param_shapes(model_cfg), run.seed, run.device)
    p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    opt = cwdm.AdamW(p, opt_cfg["lr"], opt_cfg["lr_anneal_steps"], opt_cfg["ema_rate"],
                     weight_decay=opt_cfg["weight_decay"])
    losses, grad1 = [], None
    for i in range(n_steps):
        batch, t, noise = feed(i)
        loss = cwdm.loss(p, model_cfg, batch, t, noise, run.traffic["contr"], prec)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        if i == 0:
            grad1 = _host(_norms(grads))
        opt.step(p, grads)
        del grads, loss
    with torch.no_grad():
        change = _host(_norms({k: v - init[k] for k, v in p.items()}))
        ema = _host(_norms({k: v - init[k] for k, v in opt.ema.items()}))
    return {"loss": losses, "grad1": grad1, "change": change, "ema": ema}


def leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |‖got‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in names}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared (each the worst of its leaves or steps); the three
    worst leaves of each go to standard error."""
    med = float(np.median(list(ref["grad1"].values())))
    moved = {k for k, v in ref["grad1"].items() if v >= 1e-3 * med}
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))}
    for name, key, keep in (("grad1_gap", "grad1", None), ("change_gap", "change", moved),
                            ("ema_gap", "ema", moved)):
        gaps = leaf_gaps(prog[key], ref[key], keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        harness.log(**{f"worst_{key}": [[k, gaps[k], ref[key][k]] for k in worst]})
        out[name] = gaps[worst[0]]
    return out
