"""The port's DDIM and DPM-Solver++ samplers against the executed-reference
DDIM golden chain and against the JAX package's loops on the same noise."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.diffusion import dpm as jdpm
from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JGaussianDiffusion
from fast_cwdm_tpu_torch.diffusion import dpm
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel

torch.set_num_threads(2)

DDIM_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ddim_trace_torch.npz")
SHAPE = (2, 4, 4, 4, 8)


def _last(a):
    return np.transpose(a, (0, 2, 3, 4, 1))


def smooth_model(x, t):
    """tests/test_dpm.py's smooth x0-predictor, in torch."""
    tt = t.float().reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.tanh(0.7 * x[..., :8] + 0.05 * tt) * 0.8


def jsmooth_model(x, t, **kwargs):
    tt = jnp.asarray(t, jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    return jnp.tanh(0.7 * x[..., :8] + 0.05 * tt) * 0.8


def _noise(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_ddim_chain_matches_reference():
    """Each eta=0 DDIM step against the executed reference (atol 5e-5), as
    tests/test_diffusion_trace.py::test_ddim_chain_matches_reference."""
    data = np.load(DDIM_GOLDEN)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd.")}
    model = UNetModel(
        image_size=16, in_channels=8, model_channels=16, out_channels=8,
        num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2), dims=3,
        num_groups=8, resblock_updown=True, bottleneck_attention=False, resample_2d=False,
    )
    model.load_state_dict(sd, strict=True)
    model.eval()
    diff = GaussianDiffusion.named("linear", 10, "sampled")

    def model_fn(x, t):
        return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)

    x = torch.from_numpy(_last(data["__x_init__"]))
    with torch.no_grad():
        for k, i in enumerate(range(9, -1, -1)):
            t = torch.full((1,), i, dtype=torch.long)
            x = diff.ddim_sample(model_fn, x, t, eta=0.0)["sample"]
            np.testing.assert_allclose(
                x.numpy(), _last(data["__steps__"][k]), atol=5e-5,
                err_msg=f"ddim diverged at reverse step {k} (t={i})",
            )


def test_ddim_loop_with_eta_matches_jax():
    """eta > 0: the JAX loop's per-step noise (its key stream, rebuilt with
    jax.random) handed to the port."""
    d, jd = (cls.named("linear", 10, "sampled") for cls in (GaussianDiffusion, JGaussianDiffusion))
    key = jax.random.PRNGKey(4)
    ref = jd.ddim_sample_loop(jsmooth_model, SHAPE, key, eta=0.5)
    key_init, key_loop = jax.random.split(key)
    noise = np.array(jax.random.normal(key_init, SHAPE, jnp.float32))
    step_noise = np.stack([np.array(jax.random.normal(k, SHAPE, jnp.float32))
                           for k in jax.random.split(key_loop, 10)])
    ours = d.ddim_sample_loop(smooth_model, SHAPE, noise=torch.from_numpy(noise),
                              step_noise=torch.from_numpy(step_noise), eta=0.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("num_timesteps,steps", [(1000, 10), (1000, 25), (10, 10), (20, 6)])
def test_timestep_indices_and_tables_match_jax(num_timesteps, steps):
    idx = dpm.dpm_timestep_indices(num_timesteps, steps)
    np.testing.assert_array_equal(idx, jdpm.dpm_timestep_indices(num_timesteps, steps))
    acp = GaussianDiffusion.named("linear", num_timesteps, "sampled").alphas_cumprod
    for order in (1, 2):
        for ours, ref in zip(dpm._solver_tables(acp, idx, order),
                             jdpm._solver_tables(acp, idx, order)):
            assert ours.dtype == np.float32
            np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        dpm.dpm_timestep_indices(10, 11)
    with pytest.raises(ValueError):
        dpm._solver_tables(acp, idx, 3)


@pytest.mark.parametrize("order", [1, 2])
def test_dpm_solver_pp_loop_matches_jax(order):
    """The 2M chain (and its first-order form) on the smooth model, the
    same initial latent on both sides, atol 2e-5."""
    d, jd = (cls.named("linear", 200, "sampled") for cls in (GaussianDiffusion, JGaussianDiffusion))
    noise = _noise(11)
    ref = jd.dpm_solver_pp_loop(jsmooth_model, SHAPE, jax.random.PRNGKey(0),
                                noise=jnp.asarray(noise), steps=20, order=order)
    ours = d.dpm_solver_pp_loop(smooth_model, SHAPE, noise=torch.from_numpy(noise),
                                steps=20, order=order)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


def test_dpm_order1_equals_ddim():
    """order=1 over every step is algebraically the eta=0 DDIM chain."""
    d = GaussianDiffusion.named("linear", 10, "sampled")
    noise = torch.from_numpy(_noise(3))
    ddim = d.ddim_sample_loop(smooth_model, SHAPE, noise=noise)
    dpm1 = d.dpm_solver_pp_loop(smooth_model, SHAPE, noise=noise, steps=10, order=1)
    np.testing.assert_allclose(dpm1.numpy(), ddim.numpy(), rtol=0, atol=5e-5)


def test_dpm_initial_latent_from_generator():
    """Without ``noise`` the latent is drawn from the generator on the
    given device: the same seed gives the same chain."""
    d = GaussianDiffusion.named("linear", 10, "sampled")
    runs = [d.dpm_solver_pp_loop(smooth_model, SHAPE, steps=5, device="cpu",
                                 generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == SHAPE
