"""The rest of ``GaussianDiffusion``'s public API in the port against the
JAX package: the known-image and interpolation loops (ancestral and DDIM),
the progressive generators, ``ddim_reverse_sample``, the variational bound
(``vb_terms_bpd``, ``prior_bpd``, ``calc_bpd_loop``) and
``LossType.is_vb``.

The JAX methods draw from one key; the port takes the same draws as
tensors (``noise``, ``step_noise``), rebuilt here with ``jax.random`` in
the order each JAX method splits its key. Weights: the seeded state dict
on both sides (a tiny i2i UNet, fp32). Tolerances: atol 1e-4 for a chain
(several forwards of the 5e-5 single-forward tolerance), 5e-5 for a
single step; the bound's bits, which divide by small posterior variances,
rtol 1e-4 on top. The oracle tests repeat the JAX package's own
(tests/test_diffusion.py, tests/test_api_surface.py) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from fast_cwdm_tpu.diffusion.gaussian import LossType as JLossType
from fast_cwdm_tpu.models import UNetModel as JUNetModel
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion, LossType
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.ops.wavelet import haar_clamp_project
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

CFG = dict(image_size=16, in_channels=32, model_channels=16, out_channels=8,
           num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2), dims=3,
           num_groups=8, resblock_updown=True, bottleneck_attention=False,
           resample_2d=False)
SHAPE = (1, 8, 8, 8, 8)
STEPS = 6
CHAIN, STEP = 1e-4, 5e-5


@pytest.fixture(scope="module")
def setup():
    """The port's model_fn, the JAX apply, the two diffusions, a
    condition, two known latents."""
    model = UNetModel(**CFG)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.eval()
    jmodel = JUNetModel(**CFG)
    params = torch_to_flax(sd, jmodel)
    rng = np.random.default_rng(0)
    cond = rng.random((1, 8, 8, 8, 24)).astype(np.float32)
    img1 = rng.random(SHAPE).astype(np.float32)
    img2 = rng.random(SHAPE).astype(np.float32)

    def fn(x, t):
        with torch.no_grad():
            return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)

    return dict(
        fn=fn, japply=lambda p: (lambda x, t: jmodel.apply({"params": p}, x, t)),
        params=params, diff=GaussianDiffusion.named("linear", STEPS, "sampled", mode="i2i"),
        jdiff=JDiffusion.named("linear", STEPS, "sampled", mode="i2i"),
        cond=cond, img1=img1, img2=img2)


def _np(x):
    return torch.from_numpy(np.array(x))


def _normal(key, shape=SHAPE):
    return _np(jax.random.normal(key, shape, jnp.float32))


def _loop_noise(key, n):
    """x_T and the per-step noise of JAX's p_sample_loop / ddim_sample_loop
    under ``key`` (key_init, then ``n`` keys split at once)."""
    key_init, key_loop = jax.random.split(key)
    return _normal(key_init), [_normal(k) for k in jax.random.split(key_loop, n)]


def _progressive_noise(key, n):
    """x_T and the per-step noise of JAX's progressive generators: the
    loop key is split one step at a time."""
    key_init, key_loop = jax.random.split(key)
    out = []
    for _ in range(n):
        key_loop, sub = jax.random.split(key_loop)
        out.append(_normal(sub))
    return _normal(key_init), out


def _close(ours, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol, rtol=rtol)


def test_loss_type_is_vb():
    for name in ("mse", "rescaled_mse", "kl", "rescaled_kl"):
        assert LossType(name).is_vb() == JLossType(name).is_vb()
    assert LossType.KL.is_vb() and LossType.RESCALED_KL.is_vb()
    assert not LossType.MSE.is_vb() and not LossType.RESCALED_MSE.is_vb()


@pytest.mark.parametrize("noise_level", [4, 50])
def test_sample_known_matches_jax(setup, noise_level):
    """q_sample of the known image with the first draw, then the chain of
    min(noise_level, T) steps (noise_level 50 > T: the whole chain)."""
    s = setup
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda p, im, c: s["jdiff"].sample_known(
        s["japply"](p), im, key, cond=c, noise_level=noise_level))(
        s["params"], s["img1"], s["cond"])
    n = min(noise_level, STEPS)
    key_noise, key_loop = jax.random.split(key)
    _, step_noise = _loop_noise(key_loop, n)
    ours = s["diff"].sample_known(
        s["fn"], torch.from_numpy(s["img1"]), cond=torch.from_numpy(s["cond"]),
        noise=_normal(key_noise), step_noise=step_noise, noise_level=noise_level)
    assert ours.shape == SHAPE
    _close(ours, ref, CHAIN)


def test_p_sample_loop_interpolation_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p, a, b, c: s["jdiff"].p_sample_loop_interpolation(
        s["japply"](p), SHAPE, key, img1=a, img2=b, lambdaint=0.3, cond=c,
        noise_level=5))(s["params"], s["img1"], s["img2"], s["cond"])
    key_noise, key_loop = jax.random.split(key)
    _, step_noise = _loop_noise(key_loop, 5)
    img1, img2 = torch.from_numpy(s["img1"]), torch.from_numpy(s["img2"])
    sample, interpol, r1, r2 = s["diff"].p_sample_loop_interpolation(
        s["fn"], SHAPE, img1=img1, img2=img2, lambdaint=0.3,
        cond=torch.from_numpy(s["cond"]), noise=_normal(key_noise), step_noise=step_noise,
        noise_level=5)
    assert r1 is img1 and r2 is img2
    _close(interpol, ref[1], STEP)
    _close(sample, ref[0], CHAIN)


def test_p_sample_loop_progressive_matches_jax(setup):
    """Every yielded step against JAX's generator (keys split one step at
    a time), and the last one is where the port's own loop ends."""
    s = setup
    key = jax.random.PRNGKey(5)
    cond = jnp.asarray(s["cond"])
    refs = list(s["jdiff"].p_sample_loop_progressive(
        s["japply"](s["params"]), SHAPE, key, cond=cond))
    x_t, step_noise = _progressive_noise(key, STEPS)
    tcond = torch.from_numpy(s["cond"])
    outs = list(s["diff"].p_sample_loop_progressive(
        s["fn"], SHAPE, cond=tcond, noise=x_t, step_noise=step_noise))
    assert len(outs) == len(refs) == STEPS
    for o, r in zip(outs, refs):
        assert set(o) == set(r) == {"sample", "pred_xstart"}
        _close(o["sample"], r["sample"], CHAIN)
        _close(o["pred_xstart"], r["pred_xstart"], CHAIN)
    loop = s["diff"].p_sample_loop(s["fn"], SHAPE, cond=tcond, noise=x_t, step_noise=step_noise)
    assert torch.equal(outs[-1]["sample"], loop)


def test_ddim_reverse_sample_matches_jax(setup):
    """One ODE step x_t → x_{t+1} at three timesteps (not t = 0, where ε =
    (x_t − x̂0)/√(1/ᾱ − 1) divides by 0.01 and the step's scale is ~100)."""
    s = setup
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    for ti in (1, 2, STEPS - 2):
        ref = jax.jit(lambda p, xx, c, tt: s["jdiff"].ddim_reverse_sample(
            s["japply"](p), xx, tt, cond=c))(
            s["params"], x, s["cond"], jnp.full((1,), ti, jnp.int32))
        ours = s["diff"].ddim_reverse_sample(
            s["fn"], torch.from_numpy(x), torch.full((1,), ti, dtype=torch.long),
            cond=torch.from_numpy(s["cond"]))
        _close(ours["sample"], ref["sample"], STEP)
        _close(ours["pred_xstart"], ref["pred_xstart"], STEP)


def test_ddim_sample_loop_known_matches_jax(setup):
    """i2i: fresh noise at the target shape, img as the condition; returns
    (sample, None, img); other modes raise."""
    s = setup
    key = jax.random.PRNGKey(6)
    ref, none, _ = jax.jit(lambda p, im: s["jdiff"].ddim_sample_loop_known(
        s["japply"](p), SHAPE, key, img=im, noise_level=4))(s["params"], s["cond"])
    assert none is None
    x_t, _ = _loop_noise(key, 4)
    img = torch.from_numpy(s["cond"])
    sample, x_noisy, ret = s["diff"].ddim_sample_loop_known(
        s["fn"], SHAPE, img=img, noise=x_t, noise_level=4)
    assert x_noisy is None and ret is img
    _close(sample, ref, CHAIN)
    plain = GaussianDiffusion.named("linear", STEPS, "sampled")
    with pytest.raises(ValueError, match="i2i"):
        plain.ddim_sample_loop_known(s["fn"], SHAPE, img=img)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_interpolation_matches_jax(setup, eta):
    s = setup
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda p, a, b, c: s["jdiff"].ddim_sample_loop_interpolation(
        s["japply"](p), SHAPE, key, img1=a, img2=b, lambdaint=0.6, cond=c, eta=eta,
        noise_level=5))(s["params"], s["img1"], s["img2"], s["cond"])
    key_noise, key_loop = jax.random.split(key)
    _, step_noise = _loop_noise(key_loop, 5)
    sample, interpol, _, _ = s["diff"].ddim_sample_loop_interpolation(
        s["fn"], SHAPE, img1=torch.from_numpy(s["img1"]), img2=torch.from_numpy(s["img2"]),
        lambdaint=0.6, cond=torch.from_numpy(s["cond"]), noise=_normal(key_noise),
        step_noise=step_noise, eta=eta, noise_level=5)
    _close(interpol, ref[1], STEP)
    _close(sample, ref[0], CHAIN)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_progressive_matches_jax(setup, eta):
    s = setup
    key = jax.random.PRNGKey(8)
    refs = list(s["jdiff"].ddim_sample_loop_progressive(
        s["japply"](s["params"]), SHAPE, key, cond=jnp.asarray(s["cond"]), eta=eta))
    x_t, step_noise = _progressive_noise(key, STEPS)
    tcond = torch.from_numpy(s["cond"])
    outs = list(s["diff"].ddim_sample_loop_progressive(
        s["fn"], SHAPE, cond=tcond, noise=x_t, step_noise=step_noise, eta=eta))
    assert len(outs) == STEPS
    for o, r in zip(outs, refs):
        _close(o["sample"], r["sample"], CHAIN)
    loop = s["diff"].ddim_sample_loop(s["fn"], SHAPE, cond=tcond, noise=x_t,
                                      step_noise=step_noise, eta=eta)
    assert torch.equal(outs[-1]["sample"], loop)


def test_progressive_generators_follow_their_loops_on_one_generator(setup):
    """Drawing from a torch.Generator, each generator yields T steps and
    its last sample equals its loop's on the same seed, bit for bit."""
    s = setup
    cond = torch.from_numpy(s["cond"])
    d = s["diff"]
    for prog, loop, kw in ((d.p_sample_loop_progressive, d.p_sample_loop, {}),
                           (d.ddim_sample_loop_progressive, d.ddim_sample_loop, {"eta": 0.3})):
        outs = list(prog(s["fn"], SHAPE, cond=cond,
                         generator=torch.Generator().manual_seed(2), **kw))
        ref = loop(s["fn"], SHAPE, cond=cond, generator=torch.Generator().manual_seed(2), **kw)
        assert len(outs) == d.num_timesteps
        assert torch.equal(outs[-1]["sample"], ref)


def _near_identity(s):
    """The model as a 1e-3 correction to an identity x0-predictor, on both
    sides. At t = 0 the decoder's std is 0.01, and its bin probabilities
    come from the tanh approximation of the normal CDF in float32: a few
    std from the mean, 1 + tanh cancels and XLA's and torch's tanh differ
    by whole percents (1.5e-3 of the mean NLL for offsets up to 5 std on
    identical inputs). With this model x0 lies within ~4 std of the mean
    and the two sides agree."""

    def ours(x, t):
        return x[..., :8] + 1e-3 * s["fn"](x, t)

    def theirs(p):
        apply = s["japply"](p)
        return lambda x, t: x[..., :8] + 1e-3 * apply(x, t)

    return ours, theirs


def _known_latent(diff, seed):
    """x0, the wavelet latent of an image in [0, 1] (so that the x0
    projection of clip_denoised keeps it), and, per t, x_t = q_sample(x0,
    t, noise)."""
    rng = np.random.default_rng(seed)
    x0 = haar_clamp_project(torch.from_numpy(
        rng.uniform(-1, 1, SHAPE).astype(np.float32))).numpy()
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    xt = {ti: (diff.sqrt_alphas_cumprod[ti] * x0
               + diff.sqrt_one_minus_alphas_cumprod[ti] * noise).astype(np.float32)
          for ti in range(STEPS)}
    return x0, xt


def test_vb_terms_and_prior_bpd_match_jax(setup):
    """The bound's term at t = 0 (decoder NLL) and t > 0 (KL), and the
    prior term."""
    s = setup
    ours_fn, theirs_fn = _near_identity(s)
    x0, xt = _known_latent(s["diff"], 2)
    for ti in (0, 3):
        t = jnp.full((1,), ti, jnp.int32)
        ref = jax.jit(lambda p, a, b, c, tt: s["jdiff"].vb_terms_bpd(
            theirs_fn(p), a, b, tt, cond=c, clip_denoised=False))(
            s["params"], x0, xt[ti], s["cond"], t)
        ours = s["diff"].vb_terms_bpd(ours_fn, torch.from_numpy(x0), torch.from_numpy(xt[ti]),
                                      torch.full((1,), ti, dtype=torch.long),
                                      cond=torch.from_numpy(s["cond"]), clip_denoised=False)
        _close(ours["output"], ref["output"], STEP, rtol=1e-4)
        _close(ours["pred_xstart"], ref["pred_xstart"], STEP)
    _close(s["diff"].prior_bpd(torch.from_numpy(x0)), s["jdiff"].prior_bpd(jnp.asarray(x0)),
           STEP, rtol=1e-5)


@pytest.mark.parametrize("clip_denoised", [False, True])
def test_calc_bpd_loop_matches_jax(setup, clip_denoised):
    """JAX's keys and shapes; total = Σ vb + prior to rtol 1e-5; each term
    against JAX on its noise (one key split per timestep)."""
    s = setup
    ours_fn, theirs_fn = _near_identity(s)
    x0, _ = _known_latent(s["diff"], 3)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(lambda p, a, c: s["jdiff"].calc_bpd_loop(
        theirs_fn(p), a, key, cond=c, clip_denoised=clip_denoised))(
        s["params"], x0, s["cond"])
    noise, k = [], key
    for _ in range(STEPS):
        k, sub = jax.random.split(k)
        noise.append(_normal(sub))
    ours = s["diff"].calc_bpd_loop(ours_fn, torch.from_numpy(x0),
                                   cond=torch.from_numpy(s["cond"]), step_noise=noise,
                                   clip_denoised=clip_denoised)
    assert set(ours) == set(ref) == {"total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"}
    for name, v in ours.items():
        assert tuple(v.shape) == tuple(ref[name].shape), name
        _close(v, ref[name], CHAIN, rtol=1e-4)
    np.testing.assert_allclose(ours["total_bpd"].numpy(),
                               (ours["vb"].sum(1) + ours["prior_bpd"]).numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# The JAX package's oracle tests on the port
# ---------------------------------------------------------------------------


def _oracle(mode="default"):
    """A model that always predicts a fixed x0 (tests/test_diffusion.py)."""
    d = GaussianDiffusion.named("linear", 10, "sampled", mode=mode)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((1, 16, 16, 16, 1)).astype(np.float32))
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    x0 = wv.dwt_normalized(img)
    return d, x0, lambda x, t: x0.expand(*x.shape[:-1], 8)


def test_oracle_known_and_interpolation_loops_recover_x0():
    d, x0, fn = _oracle()
    g = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    out = d.sample_known(fn, x0, generator=g(), noise_level=5)
    assert out.shape == x0.shape
    _close(out, x0, 1e-4)
    sample, interpol, r1, r2 = d.p_sample_loop_interpolation(
        fn, x0.shape, img1=x0, img2=x0 + 0.1, lambdaint=0.3, noise_level=5, generator=g())
    assert sample.shape == interpol.shape == x0.shape and r1 is x0
    _close(sample, x0, 1e-4)
    # identical endpoints: the mixture does not depend on lambdaint (one
    # shared noise draw)
    ia = d.p_sample_loop_interpolation(fn, x0.shape, img1=x0, img2=x0, lambdaint=0.2,
                                       noise_level=5, generator=g())[1]
    ib = d.p_sample_loop_interpolation(fn, x0.shape, img1=x0, img2=x0, lambdaint=0.9,
                                       noise_level=5, generator=g())[1]
    _close(ia, ib, 1e-6)
    sample, _, _, _ = d.ddim_sample_loop_interpolation(
        fn, x0.shape, img1=x0, img2=x0 + 0.1, lambdaint=0.5, noise_level=5, generator=g())
    _close(sample, x0, 1e-4)
    outs = list(d.p_sample_loop_progressive(fn, x0.shape, generator=g(), device="cpu"))
    assert len(outs) == d.num_timesteps
    _close(outs[-1]["sample"], x0, 1e-4)


def test_oracle_ddim_sample_loop_known_recovers_x0():
    d, x0, _ = _oracle(mode="i2i")
    img_cond = torch.full((*x0.shape[:-1], 24), 0.5)

    def fn(x_in, t):
        assert x_in.shape[-1] == 32  # 8 noisy target + 24 condition channels
        return x0.expand(*x_in.shape[:-1], 8)

    sample, x_noisy, ret = d.ddim_sample_loop_known(
        fn, x0.shape, img=img_cond, generator=torch.Generator().manual_seed(3))
    assert x_noisy is None and ret is img_cond
    _close(sample, x0, 1e-4)


def test_wrappers_thread_cond_fn_denoised_fn_and_model_kwargs():
    """A zero cond_fn and an identity denoised_fn are exact no-ops through
    every wrapper (tests/test_diffusion.py:579-602)."""
    d, x0, fn = _oracle()
    zero_fn = lambda x, t: torch.zeros_like(x)  # noqa: E731
    extra = dict(cond_fn=zero_fn, denoised_fn=lambda x: x, model_kwargs={})
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    T = d.num_timesteps
    _close(d.sample_known(fn, x0, noise_level=T, generator=g()),
           d.sample_known(fn, x0, noise_level=T, generator=g(), **extra), 1e-6)
    for method in (d.p_sample_loop_interpolation, d.ddim_sample_loop_interpolation):
        kw = dict(img1=x0, img2=0.5 * x0, lambdaint=0.3, noise_level=T)
        base = method(fn, x0.shape, generator=g(), **kw)
        same = method(fn, x0.shape, generator=g(), **kw, **extra)
        _close(base[0], same[0], 1e-6)
        _close(base[1], same[1], 1e-6)


def test_api_surface_loops_and_bpd():
    """tests/test_api_surface.py: the known loop is finite at its shape, the
    DDIM generator yields every step, calc_bpd_loop's shapes and sum."""
    d = GaussianDiffusion.named("linear", 4, "sampled", var_type="fixed_small")
    fn = lambda x, t: torch.tanh(x)  # noqa: E731
    g = torch.Generator().manual_seed(2)
    latent = (1, 4, 4, 4, 8)
    img = torch.rand(latent, generator=g)
    out = d.p_sample_loop_known(fn, latent, img=img, noise_level=5, generator=g)
    assert out.shape == latent and torch.isfinite(out).all()
    steps = list(d.ddim_sample_loop_progressive(fn, latent, generator=g, device="cpu"))
    assert len(steps) == d.num_timesteps and steps[-1]["sample"].shape == latent
    x0 = torch.rand((2, 4, 4, 4, 8), generator=g)
    bpd = d.calc_bpd_loop(fn, x0, clip_denoised=False, generator=g)
    assert bpd["vb"].shape == (2, 4) and bpd["total_bpd"].shape == (2,)
    assert torch.isfinite(bpd["total_bpd"]).all()
    np.testing.assert_allclose(bpd["total_bpd"].numpy(),
                               (bpd["vb"].sum(1) + bpd["prior_bpd"]).numpy(), rtol=1e-5)
