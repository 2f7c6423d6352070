"""The control of the checks of synth10.attn.bf16 and train.bf16.dp4, on one
card at the cells' own size: the reference put in the program's place in fp8,
the precision just below the configuration's bf16, on the inputs of three
seeds. Each must come out not correct: over the cell's limit in at least one
number. train.bf16.dp4's control is the reference at the global batch of its
four ranks, which needs no second card. Prints every reading (``-s``).

    python -m pytest -s -m cuda -p no:cacheprovider cwdm_bench/tests/test_cwdmbench_controls_attn_dp4.py
"""

import gc
import json

import pytest
import torch

from cwdm_bench import harness, synthesis, synthesis_attn, training, training_dp
from cwdm_bench.reference import cwdm_attn

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def _run(workload: str, seed: int) -> harness.Run:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size on the card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.load_cell(workload)
    return harness.Run(seed, 0.0, False, torch.device("cuda"), spec["config"], spec["traffic"],
                       spec["limits"], 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_attention_synthesis_control_is_not_correct(seed):
    run = _run("synth10.attn.bf16", seed)
    mcfg = synthesis.model_config(run.config)
    reqs = synthesis.Requests(run, int(run.config["model"]["diffusion_steps"]))
    p = harness.draw_weights(cwdm_attn.param_shapes(mcfg), seed, run.device)
    crop_z = run.config["geometry"]["crop_z"]
    gaps = []
    for i in range(int(run.traffic["check_items"])):
        ref, mask = synthesis_attn.reference_volume(run, reqs, p, mcfg, i, "fp32")
        ctl, _ = synthesis_attn.reference_volume(run, reqs, p, mcfg, i, "fp8")
        gaps.append(synthesis.image_gap(ctl, ref, mask[..., :crop_z]))
    limit = run.limits["image_gap_mean"]
    print(json.dumps({"control": "synth10.attn.bf16", "prec": "fp8", "seed": seed,
                      "image_gap_mean": gaps, "limit": limit}), flush=True)
    del p, reqs
    gc.collect()
    assert max(gaps) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_data_parallel_training_control_is_not_correct(seed):
    run = _run("train.bf16.dp4", seed)
    mcfg = training.model_config(run.config)
    n = int(run.traffic["check_steps"])
    ref = training_dp.reference_readings(run, mcfg, n, "fp32")
    ctl = training_dp.reference_readings(run, mcfg, n, "fp8")
    gaps = training.compare(ctl, ref)
    print(json.dumps({"control": "train.bf16.dp4", "seed": seed, **gaps,
                      "limits": run.limits}), flush=True)
    gc.collect()
    assert any(gaps[k] > run.limits[k] for k in gaps)
