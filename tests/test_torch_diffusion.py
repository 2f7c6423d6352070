"""The port's schedules, respacing and ancestral loop against the JAX
package and the executed-reference golden chain."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.diffusion import respace as jrespace
from fast_cwdm_tpu.diffusion import schedules as jschedules
from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JGaussianDiffusion
from fast_cwdm_tpu.models import UNetModel as JUNetModel
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu_torch.diffusion import respace, schedules
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "diffusion_trace_torch.npz")
TABLES = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "fixed_large_variance", "fixed_large_log_variance",
)
# the golden chain's tiny reference UNet (tests/test_diffusion_trace.py)
TRACE_CFG = dict(
    image_size=16, in_channels=16, model_channels=16, out_channels=8,
    num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2), dims=3,
    num_groups=8, resblock_updown=True, bottleneck_attention=False, resample_2d=False,
)


def _last(a):
    return np.transpose(a, (0, 2, 3, 4, 1))


def _model_fn(model):
    def fn(x, t):
        return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)
    return fn


@pytest.mark.parametrize(
    "name,steps,sched",
    [("linear", 1000, "direct"), ("linear", 10, "sampled"), ("linear", 100, "sampled"),
     ("cosine", 50, "direct")],
)
def test_schedule_tables_match_jax(name, steps, sched):
    np.testing.assert_array_equal(
        schedules.get_named_beta_schedule(name, steps, sched),
        jschedules.get_named_beta_schedule(name, steps, sched),
    )
    ours = GaussianDiffusion.named(name, steps, sched)
    ref = JGaussianDiffusion.named(name, steps, sched)
    for tab in TABLES:
        np.testing.assert_array_equal(getattr(ours, tab), getattr(ref, tab), err_msg=tab)


@pytest.mark.parametrize("steps,spec", [(1000, "ddim50"), (100, [25, 15, 10]), (100, "10")])
def test_respacing_matches_jax(steps, spec):
    use = respace.space_timesteps(steps, spec)
    assert use == jrespace.space_timesteps(steps, spec)
    betas = schedules.get_named_beta_schedule("linear", steps, "direct")
    ours = respace.create_spaced_diffusion(use_timesteps=use, betas=betas)
    ref = jrespace.create_spaced_diffusion(use_timesteps=use, betas=betas)
    np.testing.assert_array_equal(ours.timestep_map, np.asarray(ref.timestep_map))
    np.testing.assert_array_equal(ours.betas, ref.betas)
    t = torch.arange(len(use))
    np.testing.assert_array_equal(ours.scale_timesteps(t).numpy(), np.asarray(ref.timestep_map))


@pytest.fixture(scope="module")
def trace():
    data = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd.")}
    model = UNetModel(**TRACE_CFG)
    model.load_state_dict(sd, strict=True)
    diff = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    return data, model.eval(), diff


def test_golden_chain_per_step(trace):
    """Each reverse step against the executed reference (atol 5e-5), with
    the fixture's stored per-step noise."""
    data, model, diff = trace
    x = torch.from_numpy(_last(data["__x_init__"]))
    cond = torch.from_numpy(_last(data["__cond__"]))
    with torch.no_grad():
        for k, i in enumerate(range(9, -1, -1)):
            t = torch.full((1,), i, dtype=torch.long)
            noise = torch.from_numpy(_last(data["__noises__"][k]))
            x = diff.p_sample(_model_fn(model), x, t, noise, cond=cond)["sample"]
            np.testing.assert_allclose(
                x.numpy(), _last(data["__steps__"][k]), atol=5e-5,
                err_msg=f"diverged at reverse step {k} (t={i})",
            )


def test_golden_chain_through_p_sample_loop(trace):
    """The whole loop fed the stored noises via ``noise=``/``step_noise=``."""
    data, model, diff = trace
    noises = np.stack([_last(n) for n in data["__noises__"]])
    with torch.no_grad():
        out = diff.p_sample_loop(
            _model_fn(model), (1, 16, 16, 16, 8),
            cond=torch.from_numpy(_last(data["__cond__"])),
            noise=torch.from_numpy(_last(data["__x_init__"])),
            step_noise=torch.from_numpy(noises),
        )
    np.testing.assert_allclose(out.numpy(), _last(data["__steps__"][-1]), atol=5e-5)


def test_p_sample_loop_matches_jax_with_jax_noise():
    """The JAX loop draws its noise from one key (gaussian.py:452-459); the
    same noise, rebuilt with jax.random, is handed to the port. fp32, atol
    1e-4: 10 steps of the 5e-5 single-forward tolerance."""
    cfg = dict(TRACE_CFG, in_channels=32)
    model = UNetModel(**cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = seeded_state_dict(shapes)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.eval()
    jmodel = JUNetModel(**cfg)
    params = torch_to_flax(sd, jmodel)

    rng = np.random.default_rng(0)
    cond = rng.random((1, 8, 8, 8, 24)).astype(np.float32)
    shape = (1, 8, 8, 8, 8)
    key = jax.random.PRNGKey(42)
    jdiff = JGaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    ref = jax.jit(
        lambda p, c: jdiff.p_sample_loop(
            lambda x, t: jmodel.apply({"params": p}, x, t), shape, key, cond=c
        )
    )(params, jnp.asarray(cond))

    key_init, key_loop = jax.random.split(key)
    noise = jax.random.normal(key_init, shape, jnp.float32)
    step_noise = [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(key_loop, 10)]
    diff = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    with torch.no_grad():
        ours = diff.p_sample_loop(
            _model_fn(model), shape, cond=torch.from_numpy(cond),
            noise=torch.from_numpy(np.array(noise)),
            step_noise=[torch.from_numpy(np.array(n)) for n in step_noise],
        )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_step_noise_must_cover_the_chain(trace):
    _, model, diff = trace
    with pytest.raises(ValueError, match="step_noise"):
        diff.p_sample_loop(_model_fn(model), (1, 16, 16, 16, 8),
                           cond=torch.zeros(1, 16, 16, 16, 8),
                           step_noise=[torch.zeros(1, 16, 16, 16, 8)] * 3)
