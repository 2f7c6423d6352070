"""The driver of synthesis mixes for a UNet with attention (``"kind":
"synthesis_attn"``).

``synthesis.py``'s closed loop (its ``Requests``, traced block and
``image_gap``), on a model whose parameters are laid out and drawn by
``reference/cwdm_attn.py::param_shapes`` and whose kept requests are held
against ``reference/cwdm_attn.py::synthesize``: ``synthesis.py`` builds and
checks through ``reference/cwdm.py``, which covers the UNet without
attention only. Traffic keys: as ``synthesis.py``'s.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from cwdm_bench import harness, synthesis
from cwdm_bench.reference import cwdm_attn

WARM, TRACED = synthesis.WARM, synthesis.TRACED


def build_program(model_cfg: dict, seed: int, device):
    """``(model, diffusion)`` of the program for ``model_cfg``, its parameters
    the seeded draw over ``cwdm_attn.param_shapes`` (loaded ``strict``)."""
    from fast_cwdm_tpu_torch.cli import common

    with torch.device("meta"):
        model, diffusion = common.build_model_and_diffusion(model_cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(harness.draw_weights(cwdm_attn.param_shapes(model_cfg), seed, device),
                          strict=True)
    return model, diffusion


def run(run: harness.Run) -> dict:
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.cli import common

    cfg, tr, dev = run.config, run.traffic, run.device
    run.part("import")
    if dev.type == "cuda":
        from fast_cwdm_tpu_torch.ops import _build

        _build.build()
    run.part("build")
    model_cfg = synthesis.model_config(cfg)
    model, diffusion = build_program(model_cfg, run.seed, dev)
    run.part("weights")
    steps = diffusion.num_timesteps
    reqs = synthesis.Requests(run, steps)
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
        rec.update(synthesis.traced(run, request))
    rec["device"] = harness.device_record(dev, 1)
    del synth, model, diffusion, chain
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["readings"] = check(run, reqs, model_cfg, kept)
    return rec


def check(run, reqs: synthesis.Requests, model_cfg: dict, kept: dict) -> dict:
    """The kept requests against the reference: the worst mean gap inside
    the brain between the program's volume and the reference's."""
    worst = 0.0
    p = harness.draw_weights(cwdm_attn.param_shapes(model_cfg), run.seed, run.device)
    crop_z = run.config["geometry"]["crop_z"]
    for i, img in sorted(kept.items()):
        ref, mask = reference_volume(run, reqs, p, model_cfg, i, "fp32")
        got = torch.as_tensor(img, device=run.device)
        gap = synthesis.image_gap(got, ref, mask[..., :crop_z])
        harness.log(check_request=i, image_gap_mean=gap)
        worst = max(worst, gap)
    return {"image_gap_mean": worst}


def reference_volume(run, reqs: synthesis.Requests, p: dict, model_cfg: dict, i: int,
                     prec: str):
    """The reference's volume of request ``i`` in ``prec``, and its mask."""
    cases = {m: torch.as_tensor(v, device=run.device) for m, v in reqs.cases(i).items()}
    x_t, step_noise = reqs.noise(i)
    mask = cases[reqs.known[0]]
    img = cwdm_attn.synthesize(p, model_cfg, cases, mask, x_t, step_noise, reqs.contr,
                               run.config["geometry"]["crop_z"], prec)
    return img, mask[..., 0]
