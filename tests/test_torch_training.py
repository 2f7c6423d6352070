"""The port's training path against the JAX package's, on the CPU: the
likelihood helpers, ``training_losses`` (against JAX and the golden
fixture), AdamW and its anneal against optax, the EMA warm-up, the
timestep samplers, one and three train steps (loss, per-subband MSE,
gradient max, parameters after AdamW, EMA shadows), gradient accumulation,
the lesion terms, the loss-aware sampler, gradient checkpointing and the
fused GN+SiLU model's gradients.

The JAX step draws t and the noise from one key; the port's step takes
them explicitly, so each test reproduces the JAX draws
(``jax.random.split(key, 3)``, then the sampler and ``jax.random.normal``)
and hands them over. Inputs come from a numpy seed; fp32 unless stated.

Tolerances: ``training_losses`` atol 2e-5 (the golden test's,
tests/test_diffusion_trace.py); the loss and MSE of a step 2e-5; the
gradient max 1e-5 relative; Adam's first moment (linear in the gradients)
1e-5 of its largest magnitude; parameters after AdamW and the EMA shadows
1e-3·lr plus two float32 ulps of the value (p + update rounds). The step comparisons run AdamW with eps 1e-4 on both sides: an
Adam update g/(|g| + eps) magnifies a gradient's rounding noise by 1/eps,
and at the default 1e-8 some gradients of this model (~1e-8, float32
cancellation) move by a few percent of lr on rounding alone;
``test_adamw_matches_optax`` holds the default eps on well-conditioned
gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_cwdm_tpu.diffusion import losses as jlosses
from fast_cwdm_tpu.diffusion import resample as jresample
from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from fast_cwdm_tpu.models import UNetModel as JUNet
from fast_cwdm_tpu.ops import elementwise_pallas as ep
from fast_cwdm_tpu.training import TrainState as JTrainState
from fast_cwdm_tpu.training import make_optimizer as jmake_optimizer
from fast_cwdm_tpu.training import make_train_step as jmake_train_step
from fast_cwdm_tpu.training.bridge import flax_to_torch, torch_to_flax
from fast_cwdm_tpu.training.state import update_ema as jupdate_ema
from fast_cwdm_tpu_torch.diffusion import losses, resample
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
from fast_cwdm_tpu_torch.training import state as tstate
from fast_cwdm_tpu_torch.training import train
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

MODALITIES = ("t1n", "t1c", "t2w", "t2f")
TRAIN_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "training_losses_torch.npz")
LR = 1e-4
EPS = 1e-3  # Adam eps of the step comparisons (see the module docstring)
TINY = dict(in_channels=32, model_channels=16, out_channels=8, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3, num_groups=8,
            resblock_updown=True, bottleneck_attention=False, resample_2d=False)


def _models(image_size=8, **flags):
    """The port's tiny UNet with seeded weights, the JAX one, its params."""
    model = UNetModel(image_size=image_size, **TINY, **flags)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = seeded_state_dict(shapes)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jflags = {k: v for k, v in flags.items() if k not in ("use_checkpoint", "remat_max_ds")}
    jmodel = JUNet(image_size=image_size, **TINY, **jflags)
    return model, jmodel, torch_to_flax(sd, jmodel)


def _batch(seed=0, b=2, s=8, seg=False):
    rng = np.random.default_rng(seed)
    batch = {m: rng.random((b, s, s, s, 1)).astype(np.float32) for m in MODALITIES}
    if seg:
        labels = rng.choice([0, 1, 2, 4], size=(b, s, s, s, 1), p=[0.5, 0.2, 0.15, 0.15])
        labels[-1] = 0  # one sample with an empty mask contributes exactly 0
        batch["seg"] = labels.astype(np.uint8)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _diffusions():
    return (GaussianDiffusion.named("linear", 10, "sampled", mode="i2i"),
            JDiffusion.named("linear", 10, "sampled", mode="i2i"))


def _jax_draws(key, bsz, shape, num_timesteps):
    """t and the image-space noise the JAX step draws from ``key``."""
    key_t, key_noise, _ = jax.random.split(key, 3)
    t = jax.random.randint(key_t, (bsz,), 0, num_timesteps)
    noise = jax.random.normal(key_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


def _close_trees(ours_sd, jtree, jmodel, atol, rtol=0.0):
    """|ours − JAX's| ≤ atol + rtol·|JAX's| leaf by leaf (torch names)."""
    ref = flax_to_torch(jax.tree.map(np.asarray, jtree), jmodel)
    assert set(ref) == set(ours_sd)
    worst = max(float((np.abs(np.asarray(ours_sd[k].detach()) - ref[k])
                       / (atol + rtol * np.abs(ref[k]))).max()) for k in ref)
    assert worst <= 1.0, worst


# ---------------------------------------------------------------------------
# Helpers and the loss
# ---------------------------------------------------------------------------


def test_likelihood_helpers_match_jax():
    rng = np.random.default_rng(1)
    m1, v1, m2, v2 = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(
        losses.normal_kl(*(torch.from_numpy(a) for a in (m1, v1, m2, v2))).numpy(),
        np.asarray(jlosses.normal_kl(m1, v1, m2, v2)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(losses.normal_kl(torch.from_numpy(m1), torch.from_numpy(v1),
                                                0.0, 0.0).numpy(),
                               np.asarray(jlosses.normal_kl(m1, v1, 0.0, 0.0)), atol=1e-6)
    x = np.clip(rng.standard_normal((4, 6)), -1, 1).astype(np.float32)
    x[0, :2] = (-1.0, 1.0)
    np.testing.assert_allclose(losses.approx_standard_normal_cdf(torch.from_numpy(x)).numpy(),
                               np.asarray(jlosses.approx_standard_normal_cdf(x)), atol=1e-6)
    # log_scales 0: cdf_plus − cdf_min ≈ pdf·2/255, well conditioned in
    # float32 (far in the tails the difference cancels and both sides'
    # tanh roundings show)
    means, ls = (0.1 * rng.standard_normal((4, 6))).astype(np.float32), np.zeros((4, 6), np.float32)
    np.testing.assert_allclose(
        losses.discretized_gaussian_log_likelihood(
            torch.from_numpy(x), means=torch.from_numpy(means), log_scales=torch.from_numpy(ls)).numpy(),
        np.asarray(jlosses.discretized_gaussian_log_likelihood(x, means=means, log_scales=ls)),
        rtol=1e-4)
    y = torch.arange(24.0).reshape(2, 3, 4)
    np.testing.assert_allclose(losses.mean_flat(y).numpy(), [5.5, 17.5])


def test_training_losses_matches_golden():
    """The reference torch model's recorded wavelet MSE, prediction and its
    IDWT (tests/golden/training_losses_torch.npz), atol 2e-5."""
    data = np.load(TRAIN_GOLDEN)
    model = UNetModel(image_size=16, **TINY)
    model.load_state_dict({k[3:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("sd.")}, strict=True)
    diffusion, _ = _diffusions()
    last = lambda a: torch.from_numpy(np.transpose(a, (0, 2, 3, 4, 1)))  # noqa: E731
    batch = {m: last(data[f"__batch_{m}__"]) for m in MODALITIES}
    model_fn = lambda x, t: model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)  # noqa: E731
    with torch.no_grad():
        terms, out, out_idwt = diffusion.training_losses(
            model_fn, batch, torch.from_numpy(data["__t__"]), contr="t1n",
            noise_img=last(data["__noise__"]))
    np.testing.assert_allclose(terms["mse_wav"].numpy(), data["__mse_wav__"], atol=2e-5)
    np.testing.assert_allclose(out.numpy(), last(data["__model_output__"]).numpy(), atol=2e-5)
    np.testing.assert_allclose(out_idwt.numpy(), last(data["__model_output_idwt__"]).numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("contr", ["t1n", "t2f"])
def test_training_losses_matches_jax(contr):
    model, jmodel, params = _models()
    diffusion, jdiff = _diffusions()
    batch = _batch(3)
    rng = np.random.default_rng(4)
    noise = rng.standard_normal(batch[contr].shape).astype(np.float32)
    t = np.array([9, 2])
    jterms, jout, jidwt = jdiff.training_losses(
        lambda x, tt: jmodel.apply({"params": params}, x, tt), batch, jnp.asarray(t),
        jax.random.PRNGKey(0), contr=contr, noise_img=jnp.asarray(noise))
    model_fn = lambda x, tt: model(x.permute(0, 4, 1, 2, 3), tt).permute(0, 2, 3, 4, 1)  # noqa: E731
    with torch.no_grad():
        terms, out, out_idwt = diffusion.training_losses(
            model_fn, _t(batch), torch.from_numpy(t), contr=contr,
            noise_img=torch.from_numpy(noise))
    for k in ("mse_wav", "loss_per_sample"):
        np.testing.assert_allclose(terms[k].numpy(), np.asarray(jterms[k]), atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(out_idwt.numpy(), np.asarray(jidwt), atol=2e-5)
    # noise drawn from a generator: the same draw again gives the same loss
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    with torch.no_grad():
        a = diffusion.training_losses(model_fn, _t(batch), torch.from_numpy(t), gen(), contr=contr)
        b = diffusion.training_losses(model_fn, _t(batch), torch.from_numpy(t), gen(), contr=contr)
    assert torch.equal(a[0]["mse_wav"], b[0]["mse_wav"])


def test_training_losses_refuses_an_epsilon_diffusion():
    from fast_cwdm_tpu_torch.diffusion.gaussian import MeanType

    diffusion = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i",
                                        mean_type=MeanType.EPSILON)
    with pytest.raises(ValueError, match="x0-predictor"):
        diffusion.training_losses(None, _t(_batch()), torch.zeros(2, dtype=torch.long))


# ---------------------------------------------------------------------------
# Optimizer, EMA, samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay,anneal", [(0.0, 0), (0.05, 5)])
def test_adamw_matches_optax(weight_decay, anneal):
    """Six updates of random gradients (past the anneal's end): the port's
    AdamW against optax.adamw through the JAX package's make_optimizer."""
    rng = np.random.default_rng(2)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    tx = jmake_optimizer(1e-2, weight_decay=weight_decay, lr_anneal_steps=anneal)
    opt = train.make_optimizer(1e-2, weight_decay=weight_decay, lr_anneal_steps=anneal)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = opt.init(tp)
    for i in range(6):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** (i - 3)).astype(np.float32)
             for k, v in p0.items()}
        upd, jst = tx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, st)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert st["count"] == int(jst[0].count) == 6
    for k in p0:
        np.testing.assert_allclose(st["mu"][k].numpy(), np.asarray(jst[0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(st["nu"][k].numpy(), np.asarray(jst[0].nu[k]), rtol=1e-6)
    if anneal:
        assert opt.learning_rate(anneal) == 0.0 and opt.learning_rate(0) == np.float32(1e-2)


def test_ema_warmup_matches_jax():
    """rate_t = min(rate, (1+t)/(10+t)) with t the step after the increment,
    both shadows updated in float32 as the JAX package does."""
    rng = np.random.default_rng(6)
    p = {"w": rng.standard_normal(7).astype(np.float32)}
    e = {"w": rng.standard_normal(7).astype(np.float32)}
    tx = jmake_optimizer(1e-3)
    for step in (1, 2, 50, 200000):
        jst = JTrainState.create(jax.tree.map(jnp.asarray, p), tx, ema_rates=(0.9999, 0.99))
        jst = jst.replace(step=jnp.asarray(step, jnp.int32),
                          ema_params=(jax.tree.map(jnp.asarray, e),) * 2)
        ref = jupdate_ema(jst, jax.tree.map(jnp.asarray, p))
        st = tstate.TrainState(step=step, params={"w": torch.from_numpy(p["w"])}, opt_state={},
                               ema_params=tuple({"w": torch.from_numpy(e["w"].copy())} for _ in range(2)),
                               ema_rates=(0.9999, 0.99))
        tstate.update_ema(st)
        for ours, theirs in zip(st.ema_params, ref):
            np.testing.assert_allclose(ours["w"].numpy(), np.asarray(theirs["w"]), rtol=1e-6, atol=1e-7)


def test_samplers():
    """create_named_schedule_sampler, the uniform draw's range, and the
    loss-aware sampler's state update and weights against the JAX
    package's on the same t and losses (history 3, 4 timesteps)."""
    assert isinstance(resample.create_named_schedule_sampler("uniform", 10), resample.UniformSampler)
    with pytest.raises(NotImplementedError):
        resample.create_named_schedule_sampler("nope", 10)
    t, w = resample.UniformSampler(10).sample(torch.Generator().manual_seed(0), 64)
    assert t.min() >= 0 and t.max() <= 9 and bool((w == 1).all())
    ours = resample.create_named_schedule_sampler("loss-second-moment", 4)
    ours.history_per_term = 3
    theirs = jresample.LossSecondMomentResampler(4, history_per_term=3)
    st, jst = ours.init_state(), theirs.init_state()
    rng = np.random.default_rng(7)
    for _ in range(6):
        t = rng.integers(0, 4, size=3)
        ls = rng.random(3).astype(np.float32)
        st = ours.update(st, torch.from_numpy(t), torch.from_numpy(ls))
        jst = theirs.update(jst, jnp.asarray(t), jnp.asarray(ls))
        np.testing.assert_array_equal(st.loss_counts.numpy(), np.asarray(jst.loss_counts))
        np.testing.assert_allclose(st.loss_history.numpy(), np.asarray(jst.loss_history))
        np.testing.assert_allclose(ours.weights(st).numpy(), np.asarray(theirs._weights(jst)),
                                   rtol=1e-6)
    assert bool((st.loss_counts == 3).all())  # warmed: importance weights
    t, w = ours.sample(torch.Generator().manual_seed(1), 5, st)
    np.testing.assert_allclose(w.numpy(), 1.0 / (4 * ours.weights(st)[t].numpy()), rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step against JAX's
# ---------------------------------------------------------------------------


_JAX_STEPS: dict = {}


def _run_both(n_steps, *, accum_steps=1, lesion=None, sampler=None, ema_rates=(0.99,),
              flags=None, seed=0):
    """n_steps of the JAX step and of the port's on the same weights, batch,
    t and noise; returns the two final states, the metrics and the models."""
    flags = flags or {}
    model, jmodel, params = _models(**flags)
    diffusion, jdiff = _diffusions()
    batch = _batch(seed, b=2, seg=bool(lesion))
    lesion = lesion or {}
    key = (accum_steps, tuple(sorted(lesion.items())), bool(sampler))
    if key not in _JAX_STEPS:  # one compile per configuration
        tx = jmake_optimizer(LR, lr_anneal_steps=4, eps=EPS)
        js = jresample.LossSecondMomentResampler(10, history_per_term=1) if sampler else None
        _JAX_STEPS[key] = (tx, js, jmake_train_step(jmodel, jdiff, tx, contr="t1n", mode="i2i",
                                                    sampler=js, accum_steps=accum_steps,
                                                    **lesion))
    tx, jsampler, jstep = _JAX_STEPS[key]
    opt = train.make_optimizer(LR, lr_anneal_steps=4, eps=EPS)
    psampler = resample.LossSecondMomentResampler(10, history_per_term=1) if sampler else None
    jstate = JTrainState.create(params, tx, ema_rates=ema_rates,
                                sampler_state=jsampler.init_state() if sampler else ())
    state = tstate.TrainState.create(model, opt, ema_rates=ema_rates,
                                     sampler_state=psampler.init_state() if sampler else ())
    step = train.make_train_step(model, diffusion, opt, contr="t1n", mode="i2i",
                                 sampler=psampler, accum_steps=accum_steps, **lesion)
    jbatch = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(seed + 11)
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        if sampler:
            key_t = jax.random.split(sub, 3)[0]
            jt, _ = jsampler.sample(key_t, 2, jstate.sampler_state)
            t = torch.from_numpy(np.array(jt)).long()
            noise = _jax_draws(sub, 2, batch["t1n"].shape, 10)[1]
        else:
            t, noise = _jax_draws(sub, 2, batch["t1n"].shape, 10)
        jstate, jm = jstep(jstate, jbatch, sub)
        state, m = step(state, _t(batch), t=t, noise_img=noise)
        np.testing.assert_array_equal(m["t"].numpy(), np.asarray(jm["t"]))
    return state, m, jstate, jm, model, jmodel


def _check_step(state, m, jstate, jm, model, jmodel, n_steps):
    assert state.step == int(jstate.step) == n_steps
    assert state.opt_state["count"] == int(jstate.opt_state[0].count)
    for k in ("loss", "mse_wav", "loss_per_sample"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), atol=2e-5)
    for k in ("grad_max", "param_max"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    for k in train.IMAGE_METRIC_KEYS:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), atol=2e-5)
    mu_scale = max(float(v.abs().max()) for v in state.opt_state["mu"].values())
    _close_trees(state.opt_state["mu"], jstate.opt_state[0].mu, jmodel, 1e-5 * mu_scale)
    _close_trees(dict(model.named_parameters()), jstate.params, jmodel, 5e-3 * LR, 2.0**-22)
    for ours, theirs in zip(state.ema_params, jstate.ema_params):
        _close_trees(ours, theirs, jmodel, 5e-3 * LR, 2.0**-22)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(n_steps):
    """One and three steps (the anneal at 4 steps, so the lr moves): loss,
    per-subband MSE, per-sample loss, gradient and parameter max, the
    image panels, the parameters after AdamW and the EMA shadow."""
    _check_step(*_run_both(n_steps), n_steps)


def test_train_step_with_grad_accumulation_matches_jax():
    """accum_steps=2 on batch 2: the full-batch noise drawn once and
    sliced, gradients summed in order and halved, one optimizer step."""
    _check_step(*_run_both(2, accum_steps=2), 2)


def test_train_step_with_lesion_terms_matches_jax():
    """lesion_weight and lesion_core_weight with lesion_t_power: the
    per-sample masked means (one sample's mask empty), t-weighted."""
    lesion = dict(lesion_weight=0.5, lesion_core_weight=2.0, lesion_t_power=1.5)
    state, m, jstate, jm, model, jmodel = _run_both(2, lesion=lesion)
    _check_step(state, m, jstate, jm, model, jmodel, 2)
    for k in ("mse_lesion", "mse_lesion_core"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=2e-5)
        assert float(m[k]) > 0


def test_train_step_with_the_loss_aware_sampler_matches_jax():
    """LossSecondMomentResampler (history 1): t from the JAX sampler on its
    state; the state the two steps leave behind agrees."""
    state, m, jstate, jm, model, jmodel = _run_both(3, sampler=True)
    _check_step(state, m, jstate, jm, model, jmodel, 3)
    np.testing.assert_array_equal(state.sampler_state.loss_counts.numpy(),
                                  np.asarray(jstate.sampler_state.loss_counts))
    np.testing.assert_allclose(state.sampler_state.loss_history.numpy(),
                               np.asarray(jstate.sampler_state.loss_history), atol=2e-5)


def test_train_step_refuses_bad_settings():
    model, _, _ = _models()
    diffusion, _ = _diffusions()
    opt = train.make_optimizer(LR)
    with pytest.raises(ValueError, match="accum_steps"):
        train.make_train_step(model, diffusion, opt, accum_steps=0)
    with pytest.raises(ValueError, match="reward lesion error"):
        train.make_train_step(model, diffusion, opt, lesion_weight=-1.0)
    with pytest.raises(ValueError, match="i2i"):
        train.make_train_step(model, diffusion, opt, mode="default", lesion_core_weight=1.0)
    step = train.make_train_step(model, diffusion, opt, accum_steps=3)
    state = tstate.TrainState.create(model, opt)
    with pytest.raises(ValueError, match="not divisible"):
        step(state, _t(_batch()), train.StepRNG.seeded(0, "cpu"))


# ---------------------------------------------------------------------------
# The model under training
# ---------------------------------------------------------------------------


def _grads(model, batch, t, noise):
    diffusion, _ = _diffusions()
    opt = train.make_optimizer(LR)
    model.zero_grad(set_to_none=True)
    model_fn = lambda x, tt: model(x.permute(0, 4, 1, 2, 3), tt).permute(0, 2, 3, 4, 1)  # noqa: E731
    terms, _, _ = diffusion.training_losses(model_fn, _t(batch), t, contr="t1n", noise_img=noise)
    terms["mse_wav"].mean().backward()
    del opt
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("remat_max_ds", [0, 1])
def test_use_checkpoint_gives_the_same_gradients(remat_max_ds):
    """use_checkpoint recomputes the ResBlocks at ds <= remat_max_ds (0: all)
    in the backward pass; the gradients equal those without it."""
    batch = _batch(8)
    t = torch.tensor([3, 7])
    noise = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 8, 8, 8, 1)).astype(np.float32))
    plain, _, _ = _models()
    remat, _, _ = _models(use_checkpoint=True, remat_max_ds=remat_max_ds)
    blocks = [m for m in remat.modules() if hasattr(m, "remat")]
    n_remat = sum(b.remat for b in blocks)
    assert n_remat == (len(blocks) if remat_max_ds == 0 else 4)  # ds = 1: 1 in, 1 down, 2 out
    ref = _grads(plain, batch, t, noise)
    got = _grads(remat, batch, t, noise)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=1e-7, rtol=1e-6)


def test_fuse_gn_silu_gradients_match_jax(monkeypatch):
    """The fused GN+SiLU model (K3 and its VJP, plain versions on the CPU)
    against the JAX package's fused model (its Pallas kernel in interpret
    mode and its custom VJP): the gradients of the wavelet loss, atol
    1e-5 against gradients of order 1e-2."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    model, jmodel, params = _models(fuse_gn_silu=True)
    diffusion, jdiff = _diffusions()
    batch = _batch(12, b=1)  # the JAX kernel takes batch 1
    t = np.array([6])
    noise = np.random.default_rng(13).standard_normal((1, 8, 8, 8, 1)).astype(np.float32)

    def jloss(p):
        terms, _, _ = jdiff.training_losses(
            lambda x, tt: jmodel.apply({"params": p}, x, tt), jax.tree.map(jnp.asarray, batch),
            jnp.asarray(t), jax.random.PRNGKey(0), contr="t1n", noise_img=jnp.asarray(noise))
        return terms["mse_wav"].mean()

    jgrads = flax_to_torch(jax.tree.map(np.asarray, jax.grad(jloss)(params)), jmodel)
    before = ec.affine_silu_bwd.launches
    got = _grads(model, batch, torch.from_numpy(t), torch.from_numpy(noise))
    assert ec.affine_silu_bwd.launches == before  # the CPU path launches nothing
    scale = max(float(np.abs(v).max()) for v in jgrads.values())
    assert scale > 1e-3
    for k, v in jgrads.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, err_msg=k)


def test_dropout_follows_train_mode():
    """Dropout acts in model.train() (the JAX package's train=True) and not
    in model.eval(); the train step puts the model in training mode."""
    model, _, _ = _models(dropout=0.5)  # seeded: the zero-init out convs would hide it
    x = torch.randn(1, 32, 4, 4, 4)
    t = torch.tensor([3])
    with torch.no_grad():
        model.eval()
        a, b = model(x, t), model(x, t)
        assert torch.equal(a, b)
        model.train()
        torch.manual_seed(0)
        c = model(x, t)
        torch.manual_seed(1)
        d = model(x, t)
    assert not torch.equal(c, d)
    diffusion, _ = _diffusions()
    opt = train.make_optimizer(LR)
    step = train.make_train_step(model, diffusion, opt)
    model.eval()
    state, m = step(tstate.TrainState.create(model, opt), _t(_batch(b=1)),
                    train.StepRNG.seeded(0, "cpu"))
    assert model.training and bool(torch.isfinite(m["loss"]))


@pytest.mark.parametrize("params_source", ["params", "ema"])
def test_eval_sample_fn_matches_jax(params_source):
    """make_eval_sample_fn after one train step (so the EMA shadow differs
    from the parameters) against the JAX package's, on the same states'
    weights and the JAX key's noise: the 10-step chain in wavelet space,
    atol 1e-4 (the synthesis tolerance; the two states agree to 5e-3·lr)."""
    from fast_cwdm_tpu.training.train import make_eval_sample_fn as jmake_eval

    state, _, jstate, _, model, jmodel = _run_both(1)
    diffusion, jdiff = _diffusions()
    rng = np.random.default_rng(14)
    cond = rng.standard_normal((1, 4, 4, 4, 24)).astype(np.float32)
    key = jax.random.PRNGKey(15)
    ref = np.asarray(jmake_eval(jmodel, jdiff, params_source=params_source)(
        jstate, jnp.asarray(cond), key))
    shape = (1, 4, 4, 4, 8)
    key_init, key_loop = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(key_init, shape, jnp.float32)))
    step_noise = torch.from_numpy(np.stack([np.array(jax.random.normal(k, shape, jnp.float32))
                                            for k in jax.random.split(key_loop, 10)]))
    model.train()
    ours = train.make_eval_sample_fn(model, diffusion, params_source=params_source)(
        state, torch.from_numpy(cond), noise=noise, step_noise=step_noise)
    assert model.training  # restored
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    if params_source == "ema":
        plain = train.make_eval_sample_fn(model, diffusion)(
            state, torch.from_numpy(cond), noise=noise, step_noise=step_noise)
        assert not torch.equal(plain, ours)
