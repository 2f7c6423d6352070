"""The control of each cell's check, on the card at the cell's own size: the
reference put in the program's place in the precision just below the
configuration's (fp8 for bf16, TF32 for fp32 with TF32 off), on the inputs of
three seeds. Each must come out not correct: over the cell's limit in at
least one number. Prints every reading (``-s``).

    python -m pytest -s -m cuda -p no:cacheprovider cwdm_bench/tests/test_cwdmbench_control.py
"""

import gc
import json

import pytest
import torch

from cwdm_bench import harness, synthesis, training
from cwdm_bench.reference import cwdm

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def _run(workload: str, seed: int) -> harness.Run:
    spec = harness.load_cell(workload)
    return harness.Run(seed, 0.0, False, torch.device("cuda"), spec["config"], spec["traffic"],
                       spec["limits"], 0.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size on the card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["synth10.bf16", "synth10.fp32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_synthesis_control_is_not_correct(workload, seed):
    _card()
    run = _run(workload, seed)
    mcfg = synthesis.model_config(run.config)
    prec = CONTROL[run.config["precision"]["compute"]]
    reqs = synthesis.Requests(run, int(run.config["model"]["diffusion_steps"]))
    p = harness.draw_weights(cwdm.param_shapes(mcfg), seed, run.device)
    crop_z = run.config["geometry"]["crop_z"]
    gaps = []
    for i in range(int(run.traffic["check_items"])):
        ref, mask = synthesis.reference_volume(run, reqs, p, mcfg, i, "fp32")
        ctl, _ = synthesis.reference_volume(run, reqs, p, mcfg, i, prec)
        gaps.append(synthesis.image_gap(ctl, ref, mask[..., :crop_z]))
    limit = run.limits["image_gap_mean"]
    print(json.dumps({"control": workload, "prec": prec, "seed": seed, "image_gap_mean": gaps,
                      "limit": limit}), flush=True)
    del p, reqs
    gc.collect()
    assert max(gaps) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_is_not_correct(seed):
    _card()
    run = _run("train.bf16", seed)
    mcfg = training.model_config(run.config)
    feed = training.Feed(run, int(run.config["model"]["diffusion_steps"]))
    n = int(run.traffic["check_steps"])
    ref = training.reference_readings(run, mcfg, feed, n, "fp32")
    prec = CONTROL[run.config["precision"]["compute"]]
    ctl = training.reference_readings(run, mcfg, feed, n, prec)
    gaps = training.compare(ctl, ref)
    print(json.dumps({"control": "train.bf16", "seed": seed, **gaps, "limits": run.limits}),
          flush=True)
    del feed
    gc.collect()
    assert any(gaps[k] > run.limits[k] for k in gaps)
