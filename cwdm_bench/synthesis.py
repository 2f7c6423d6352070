"""The driver of synthesis mixes (``"kind": "synthesis"``).

A closed loop of one client: each request is ``batch`` cases' known
modalities, host arrays as a loader hands them over, through the program's
``cli/common.py::prepare_condition`` (upload, K1 a modality) and the ``run``
of ``make_synthesis_fn`` (the reverse chain, graphed on the card; IDWT,
clamp, mask, crop; the volume on the host). The next request starts when
the last has returned. x_T and each step's noise are drawn on the device
from a seed of the request's own, and handed to both the program and the
reference.

The chain is the ancestral ddpm sampler over every step of the
configuration's schedule, the one that ``reference/cwdm.py::synthesize``
follows. Traffic keys: ``contr`` (the missing modality), ``batch``,
``cases`` (the pool of distinct cases the requests cycle through in a
seeded order),
``trace_items`` (requests in the traced block) and ``check_items``
(requests of the window, drawn from the seed, compared with the reference).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from cwdm_bench import harness, phantom
from cwdm_bench.reference import cwdm

WARM, TRACED = 2**40, 2**41  # request indices of the warm-up and the traced block


def _latent(cfg_geo: dict) -> tuple[int, int, int]:
    x = (cfg_geo["raw"][0] - 2 * cfg_geo["crop_xy"]) // 2
    y = (cfg_geo["raw"][1] - 2 * cfg_geo["crop_xy"]) // 2
    return x, y, cfg_geo["pad_z"] // 2


def model_config(cfg: dict) -> dict:
    """The model's flags for synthesis: the configuration's model and its
    synthesis routes."""
    return {**cfg["model"], **cfg["synthesis"]}


class Requests:
    """The mix's requests: the case pool (host arrays) and each request's
    cases and noise, all from the seed."""

    def __init__(self, run: harness.Run, steps: int):
        tr, geo = run.traffic, run.config["geometry"]
        self.run, self.steps, self.batch = run, steps, int(tr["batch"])
        self.contr = tr["contr"]
        self.known = [m for m in cwdm.MODALITIES if m != self.contr]
        self.latent = (self.batch, *_latent(geo), 8)
        n = int(tr["cases"])
        self.pool = []
        for j in range(n):
            case = phantom.make_case(harness.sub_seed(run.seed, "case", j), geo, run.device)
            self.pool.append({m: case[m].cpu().numpy() for m in self.known})
        order = np.random.default_rng(harness.sub_seed(run.seed, "order")).permutation(n)
        self.order = [int(k) for k in order]

    def cases(self, i: int) -> dict:
        """Request ``i``'s host arrays: ``{modality: (batch, X, Y, Z, 1)}``."""
        picks = [self.pool[self.order[(i * self.batch + b) % len(self.pool)]]
                 for b in range(self.batch)]
        if self.batch == 1:
            return picks[0]
        return {m: np.concatenate([p[m] for p in picks]) for m in self.known}

    def noise(self, i: int):
        """Request ``i``'s x_T and per-step noise, drawn on the device."""
        g = torch.Generator(device=self.run.device).manual_seed(
            harness.sub_seed(self.run.seed, "request", i))
        x_t = torch.randn(self.latent, generator=g, device=self.run.device)
        steps = torch.randn((self.steps, *self.latent), generator=g, device=self.run.device)
        return x_t, steps


def run(run: harness.Run) -> dict:
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.cli import common

    cfg, tr, dev = run.config, run.traffic, run.device
    run.part("import")
    if dev.type == "cuda":
        from fast_cwdm_tpu_torch.ops import _build

        _build.build()
    run.part("build")
    model_cfg = model_config(cfg)
    model, diffusion = harness.build_program(model_cfg, run.seed, dev)
    run.part("weights")
    steps = diffusion.num_timesteps
    reqs = Requests(run, steps)
    run.part("cases")
    synth = common.make_synthesis_fn(model, diffusion, sampler="ddpm", device=dev,
                                     crop_z=cfg["geometry"]["crop_z"])
    mask_of = reqs.known[0]  # the sampling CLI's mask: the first known modality

    def request(i: int, spans: list | None = None) -> np.ndarray:
        cases = reqs.cases(i)
        x_t, step_noise = reqs.noise(i)
        if spans is None:
            cond = common.prepare_condition(cases, reqs.contr, device=dev)
        else:  # the traced block: the condition synchronised, as a span of its own
            with torch.profiler.record_function("bench.condition"):
                t = time.perf_counter()
                cond = common.prepare_condition(cases, reqs.contr, device=dev)
                harness.sync(dev)
                spans.append((time.perf_counter() - t) * 1e3)
        return synth(cond, cases[mask_of], noise=x_t, step_noise=step_noise)

    before = ops.launch_counts()
    request(WARM)  # warm: the chain's eager steps and its capture
    launched = ops.launches_since(before)
    run.part("warm_and_capture")
    setup_s = time.perf_counter() - run.t_start
    chain = getattr(synth, "chain", None)
    harness.log(setup_s=setup_s, setup=run.setup, launches_per_request=launched,
                capture_s=chain.graph.capture_seconds if chain and chain.graph else None)

    # the window: closed loop until --seconds have passed; a seeded
    # reservoir keeps a uniform sample of the requests for the check
    k = int(tr["check_items"])
    pick = np.random.default_rng(harness.sub_seed(run.seed, "check"))
    kept: dict[int, np.ndarray] = {}
    item_s = []
    harness.reset_peak(dev)
    ends = []
    with harness.HostLoad() as host:
        t0 = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            img = request(i)
            end = time.perf_counter()
            item_s.append(end - t)
            ends.append(end)
            if i < k:
                kept[i] = img
            else:
                j = int(pick.integers(0, i + 1))
                if j < k:
                    kept.pop(sorted(kept)[j])
                    kept[i] = img
            i += 1
            if end - t0 >= run.seconds:
                break
    window_s = end - t0
    harness.log(window_host=host.summary, volume_s_by_10s=harness.slice_rates(ends, t0),
                first_volumes_s=item_s[:10])

    rec = {"config": cfg, "model": model_cfg, "traffic": tr, "setup_s": setup_s,
           "window_s": window_s, "item_s": item_s, "items": i, "batch": reqs.batch,
           "forwards_per_item": steps, "latent": reqs.latent[1:4], "trace": None,
           "spans": {}, "attempted": i, "failed": 0}
    if run.trace:
        rec.update(traced(run, request))
    rec["device"] = harness.device_record(dev, 1)
    del synth, model, diffusion, chain
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["readings"] = check(run, reqs, model_cfg, kept)
    return rec


def traced(run, request) -> dict:
    """``trace_items`` more requests under the profiler (twice: see
    ``devtrace.traced``), the condition's upload and DWTs synchronised and
    timed as a span of their own."""
    from cwdm_bench import devtrace
    from fast_cwdm_tpu_torch import ops

    n = int(run.traffic["trace_items"])
    spans: list[float] = []

    def work(j: int) -> None:
        with torch.profiler.record_function("bench.request"):
            request(TRACED + j, spans)

    summary = devtrace.traced(work, n, ops.launch_counts, ops.launches_since, run.device,
                              timers=harness.wavelet_timers(run))
    harness.log(trace_window_s=summary["window_s"], busy_s=summary["busy_s"],
                records_missing=summary["records_missing"], launched=summary["launched"],
                filled=summary["filled"],
                outside_chain_s=devtrace.outside_chain(summary["kernels"]))
    return {"trace": summary, "trace_items": n, "spans": {"condition_ms": spans}}


def check(run, reqs: Requests, model_cfg: dict, kept: dict) -> dict:
    """The kept requests against the reference: the worst mean gap inside
    the brain between the program's volume and the reference's."""
    worst = 0.0
    p = harness.draw_weights(cwdm.param_shapes(model_cfg), run.seed, run.device)
    crop_z = run.config["geometry"]["crop_z"]
    for i, img in sorted(kept.items()):
        ref, mask = reference_volume(run, reqs, p, model_cfg, i, "fp32")
        got = torch.as_tensor(img, device=run.device)
        gap = image_gap(got, ref, mask[..., :crop_z])
        harness.log(check_request=i, image_gap_mean=gap)
        worst = max(worst, gap)
    return {"image_gap_mean": worst}


def reference_volume(run, reqs: Requests, p: dict, model_cfg: dict, i: int, prec: str):
    """The reference's volume of request ``i`` in ``prec``, and its mask."""
    cases = {m: torch.as_tensor(v, device=run.device) for m, v in reqs.cases(i).items()}
    x_t, step_noise = reqs.noise(i)
    mask = cases[reqs.known[0]]
    img = cwdm.synthesize(p, model_cfg, cases, mask, x_t, step_noise, reqs.contr,
                          run.config["geometry"]["crop_z"], prec)
    return img, mask[..., 0]


def image_gap(img: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor) -> float:
    """Mean |program − reference| over the brain's voxels."""
    inside = mask != 0
    return float((img.float() - ref).abs()[inside].mean())
