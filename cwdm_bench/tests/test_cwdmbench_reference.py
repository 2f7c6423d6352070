"""The plain reference against the program's CPU path at a tiny width: the
Haar transforms, the schedule, the UNet, a 10-step synthesis and three
training steps, on the benchmark's seeded weights and inputs."""

import numpy as np
import pytest
import torch

from cwdm_bench import harness, phantom, synthesis, training
from cwdm_bench.reference import cwdm
from cwdm_bench.tests import tiny

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _model_cfg(name="cwdm-fp32", section="synthesis"):
    cfg = tiny.config(name)
    driver = {"synthesis": synthesis, "training": training}[section]
    return cfg, driver.model_config(cfg)


def test_param_shapes_are_the_program_layout_at_production_size():
    from fast_cwdm_tpu_torch.cli import common

    cfg = harness.load_cell("synth10.bf16")["config"]["model"]
    with torch.device("meta"):
        model, _ = common.build_model_and_diffusion(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = cwdm.param_shapes(cfg)
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 81_511_048


def test_haar_matches_the_program():
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    v = torch.rand((2, 8, 6, 4, 1), generator=torch.Generator().manual_seed(0))
    bands = cwdm.dwt(v)
    torch.testing.assert_close(bands, wv.dwt_normalized(v), rtol=0, atol=1e-6)
    torch.testing.assert_close(cwdm.dwt(v, 1.0), wv.dwt3_flat(v), rtol=0, atol=1e-6)
    torch.testing.assert_close(cwdm.idwt(bands), v, rtol=0, atol=1e-6)
    torch.testing.assert_close(cwdm.project_x0(bands * 3), wv.haar_clamp_project(bands * 3),
                               rtol=0, atol=1e-6)


def test_schedule_matches_the_program():
    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion

    d = GaussianDiffusion.named("linear", 10, "sampled")
    tabs = cwdm.sampled_tables(10, CPU)
    for ours, theirs in (("sqrt_acp", "sqrt_alphas_cumprod"),
                         ("sqrt_1m_acp", "sqrt_one_minus_alphas_cumprod"),
                         ("coef1", "posterior_mean_coef1"), ("coef2", "posterior_mean_coef2"),
                         ("log_var", "fixed_large_log_variance")):
        np.testing.assert_array_equal(tabs[ours].numpy(), getattr(d, theirs))


def test_unet_matches_the_program():
    cfg, mcfg = _model_cfg()
    model, _ = harness.build_program(mcfg, 5, CPU)
    p = harness.draw_weights(cwdm.param_shapes(mcfg), 5, CPU)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 16, 16, 16, 32), generator=g)
    t = torch.tensor([7])
    with torch.no_grad():
        want = model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)
        got = cwdm.unet(p, mcfg, x, t)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert float(want.abs().mean()) > 0.1  # the seeded weights give a non-trivial output


def test_synthesis_matches_the_program():
    from fast_cwdm_tpu_torch.cli import common

    cfg, mcfg = _model_cfg()
    model, diffusion = harness.build_program(mcfg, 9, CPU)
    case = phantom.make_case(3, cfg["geometry"], CPU)
    g = torch.Generator().manual_seed(2)
    x_t = torch.randn((1, 16, 16, 16, 8), generator=g)
    steps = torch.randn((10, 1, 16, 16, 16, 8), generator=g)
    run = common.make_synthesis_fn(model, diffusion, device="cpu",
                                   crop_z=cfg["geometry"]["crop_z"])
    cond = common.prepare_condition({m: case[m].numpy() for m in case}, "t1c", device="cpu")
    want = torch.as_tensor(run(cond, case["t1n"].numpy(), noise=x_t, step_noise=steps))
    p = harness.draw_weights(cwdm.param_shapes(mcfg), 9, CPU)
    got = cwdm.synthesize(p, mcfg, case, case["t1n"], x_t, steps, "t1c",
                          cfg["geometry"]["crop_z"])
    assert got.shape == want.shape == (1, 32, 32, 30)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)  # the repo's fp32 chain bar
    inside = case["t1n"][..., 0][..., :30] != 0
    assert 0.05 < float(want[inside].std())  # not a saturated or blank volume


@pytest.mark.parametrize("prec", ["fp32", "fp8"])
def test_training_follows_the_program(prec):
    """Three steps: the losses, the first gradient and the changes of the
    program's fp32 step equal the reference's; the fp8 control departs."""
    from fast_cwdm_tpu_torch.training import state as tstate
    from fast_cwdm_tpu_torch.training import train

    cfg, mcfg = _model_cfg(section="training")
    spec = harness.load_cell("train.bf16")
    run = harness.Run(4, 0.0, False, CPU, cfg, tiny.traffic("train.bf16"), spec["limits"], 0.0)
    feed = training.Feed(run, 10)
    model, diffusion = harness.build_program(mcfg, 4, CPU)
    o = cfg["training"]
    opt = train.make_optimizer(o["lr"], lr_anneal_steps=o["lr_anneal_steps"])
    st = tstate.TrainState.create(model, opt, ema_rates=(o["ema_rate"],))
    step = train.make_train_step(model, diffusion, opt, contr="t1c")
    p0 = {k: v.detach().clone() for k, v in st.params.items()}
    losses = []
    for i in range(3):
        b, t, n = feed(i)
        st, m = step(st, b, t=t, noise_img=n)
        losses.append(float(m["loss"]))
        if i == 0:
            g1 = {k: float(v.norm()) / 0.1 for k, v in st.opt_state["mu"].items()}
    prog = {"loss": losses, "grad1": g1,
            "change": {k: float((v.detach() - p0[k]).norm()) for k, v in st.params.items()},
            "ema": {k: float((v - p0[k]).norm()) for k, v in st.ema_params[0].items()}}
    ref = training.reference_readings(run, mcfg, feed, 3, "fp32")
    if prec == "fp32":
        gaps = training.compare(prog, ref)
        assert gaps["loss_gap"] < 1e-5 and gaps["grad1_gap"] < 1e-4, gaps
        assert gaps["change_gap"] < 1e-3 and gaps["ema_gap"] < 1e-3, gaps
    else:  # the control in the program's place
        gaps = training.compare(training.reference_readings(run, mcfg, feed, 3, prec), ref)
        assert gaps["grad1_gap"] > 1e-2, gaps
