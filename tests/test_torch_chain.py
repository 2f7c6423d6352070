"""The reverse chain as the JAX package runs it: ``scan_steps``, chunked and
``params`` forms of ``p_sample_loop``, classifier guidance (``cond_fn``) in
the ddpm, ddim and dpm++ loops, ``make_synthesis_fn``'s ``chunk``,
``mesh`` and ``cuda_graph``, the captured chain's host logic, the cached
constants of ``haar_clamp_project``, and ``devtime``/``profiling``.

Same inputs on both sides (made with numpy, or JAX's key stream handed to
the port as ``noise``/``step_noise``), fp32. Latent tolerance: the JAX
package's golden atol 5e-5; image tolerance 1e-4, as the other synthesis
parity tests."""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.cli import common as jcommon
from fast_cwdm_tpu.diffusion import dpm as jdpm
from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JGaussianDiffusion
from fast_cwdm_tpu.models import UNetModel as JUNetModel
from fast_cwdm_tpu.ops import wavelet as jwv
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu.utils import profiling as jprofiling
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.diffusion import dpm, graph
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.parallel.mesh import DataMesh, SpAxis, make_mesh
from fast_cwdm_tpu_torch.utils import devtime, profiling
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

SHAPE = (2, 4, 4, 4, 8)
COND = (2, 4, 4, 4, 24)
T = 10
# the golden chain's tiny UNet (tests/test_torch_diffusion.py), i2i inputs
UNET_CFG = dict(
    image_size=16, in_channels=32, model_channels=16, out_channels=8,
    num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2), dims=3,
    num_groups=8, resblock_updown=True, bottleneck_attention=False, resample_2d=False,
)


def smooth_model(x, t):
    """A smooth x0-predictor of the 8 latent channels (i2i inputs)."""
    tt = t.float().reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.tanh(0.7 * x[..., :8] + 0.05 * tt) * 0.8


def jsmooth_model(x, t, **kwargs):
    tt = jnp.asarray(t, jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    return jnp.tanh(0.7 * x[..., :8] + 0.05 * tt) * 0.8


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_noise(key, shape, n):
    """The noise JAX's loops draw from ``key``: x_T from the first split,
    one draw per step from the second."""
    key_init, key_loop = jax.random.split(key)
    noise = np.array(jax.random.normal(key_init, shape, jnp.float32))
    steps = np.stack([np.array(jax.random.normal(k, shape, jnp.float32))
                      for k in jax.random.split(key_loop, n)])
    return noise, steps


def _diffusions(steps=T):
    return (GaussianDiffusion.named("linear", steps, "sampled", mode="i2i"),
            JGaussianDiffusion.named("linear", steps, "sampled", mode="i2i"))


@pytest.fixture(scope="module")
def unet():
    """The tiny UNet on both sides with the same seeded weights."""
    model = UNetModel(**UNET_CFG)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.eval()
    jmodel = JUNetModel(**UNET_CFG)
    params = torch_to_flax(sd, jmodel)

    def model_fn(x, t):
        return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)

    return model_fn, lambda x, t: jmodel.apply({"params": params}, x, t)


def test_scan_steps_matches_jax_with_jax_noise(unet):
    """A segment of 4 ancestral steps (t = 7 … 4) of the tiny UNet, from the
    same latent, with JAX's per-step noise (one key per step) handed over
    as ``step_noise``."""
    model_fn, jmodel_fn = unet
    d, jd = _diffusions()
    img, cond = _rand(0, SHAPE), np.random.default_rng(1).random(COND).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    ref = jd.scan_steps(jmodel_fn, jnp.asarray(img), jnp.arange(7, 3, -1), keys,
                        cond=jnp.asarray(cond))
    step_noise = [torch.from_numpy(np.array(jax.random.normal(k, SHAPE, jnp.float32)))
                  for k in keys]
    with torch.no_grad():
        ours = d.scan_steps(model_fn, torch.from_numpy(img), range(7, 3, -1), step_noise,
                            cond=torch.from_numpy(cond))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-5)


@pytest.mark.parametrize("chunk", [1, 3, T])
def test_chunked_p_sample_loop_matches_unchunked_and_jax(chunk):
    """⌈T/chunk⌉ calls of scan_steps: equal bit for bit to one call, with
    given noise and with noise drawn from a generator (one draw per step, in
    order, across segments); and to JAX's chunked run on its key's noise."""
    d, jd = _diffusions()
    cond = np.random.default_rng(2).random(COND).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jd.p_sample_loop(jsmooth_model, SHAPE, key, cond=jnp.asarray(cond), chunk_size=chunk)
    noise, step_noise = _jax_noise(key, SHAPE, T)
    kw = dict(cond=torch.from_numpy(cond), noise=torch.from_numpy(noise),
              step_noise=torch.from_numpy(step_noise))
    ours = d.p_sample_loop(smooth_model, SHAPE, chunk_size=chunk, **kw)
    assert torch.equal(ours, d.p_sample_loop(smooth_model, SHAPE, **kw))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-5)
    drawn = [d.p_sample_loop(smooth_model, SHAPE, cond=kw["cond"], chunk_size=c, device="cpu",
                             generator=torch.Generator().manual_seed(5)) for c in (chunk, None)]
    assert torch.equal(*drawn)


def test_params_form_equals_the_closure_and_jax():
    """``params=``: ``model_fn(params, x, t)``, chunked and not, equal to the
    closure over the same params; JAX's params path (its module-level
    jitted segment) on the same noise."""
    d, jd = _diffusions()
    cond = np.random.default_rng(3).random(COND).astype(np.float32)

    def with_params(p, x, t):
        return torch.tanh(p["a"] * x[..., :8] + 0.05 * t.float().reshape(-1, 1, 1, 1, 1)) * 0.8

    def jwith_params(p, x, t):
        tt = jnp.asarray(t, jnp.float32).reshape(-1, 1, 1, 1, 1)
        return jnp.tanh(p["a"] * x[..., :8] + 0.05 * tt) * 0.8

    params = {"a": torch.tensor(0.6)}
    key = jax.random.PRNGKey(9)
    ref = jd.p_sample_loop(jwith_params, SHAPE, key, cond=jnp.asarray(cond), chunk_size=4,
                           params={"a": jnp.float32(0.6)})
    noise, step_noise = _jax_noise(key, SHAPE, T)
    kw = dict(cond=torch.from_numpy(cond), noise=torch.from_numpy(noise),
              step_noise=torch.from_numpy(step_noise))
    closure = d.p_sample_loop(lambda x, t: with_params(params, x, t), SHAPE, **kw)
    for chunk in (None, 4):
        ours = d.p_sample_loop(with_params, SHAPE, params=params, chunk_size=chunk, **kw)
        assert torch.equal(ours, closure)
    np.testing.assert_allclose(closure.numpy(), np.asarray(ref), atol=5e-5)


def cond_fn(x, t, **kwargs):
    """∇ₓ of −½‖x − c‖² (c = 0.3), scaled by 0.5."""
    return 0.5 * (0.3 - x)


def jcond_fn(x, t, **kwargs):
    return 0.5 * (0.3 - x)


def test_condition_mean_and_score_match_jax():
    """Both guidance rules on one model evaluation (i2i: x_ref is the
    latent's 8 channels), against JAX's."""
    d, jd = _diffusions()
    x, cond = _rand(4, SHAPE), np.random.default_rng(5).random(COND).astype(np.float32)
    t = np.array([6, 2])
    pmv = d.p_mean_variance(smooth_model, torch.from_numpy(x), torch.from_numpy(t),
                            cond=torch.from_numpy(cond))
    jpmv = jd.p_mean_variance(jsmooth_model, jnp.asarray(x), jnp.asarray(t),
                              cond=jnp.asarray(cond))
    mean = d.condition_mean(cond_fn, pmv, torch.from_numpy(x), torch.from_numpy(t))
    jmean = jd.condition_mean(jcond_fn, jpmv, jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=5e-5)
    out = d.condition_score(cond_fn, pmv, torch.from_numpy(x), torch.from_numpy(t))
    jout = jd.condition_score(jcond_fn, jpmv, jnp.asarray(x), jnp.asarray(t))
    for k in ("pred_xstart", "mean", "variance", "log_variance"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=5e-5, err_msg=k)
    assert not torch.equal(out["mean"], pmv["mean"])


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "ddim_eta", "dpm++"])
def test_cond_fn_in_the_loops_matches_jax(sampler):
    """``cond_fn`` in the ddpm (condition_mean), ddim at eta 0 and 0.5 and
    dpm++ (condition_score) loops, i2i, against JAX's on its key's noise;
    guidance moves the result."""
    d, jd = _diffusions()
    cond = np.random.default_rng(6).random(COND).astype(np.float32)
    key = jax.random.PRNGKey(11)
    noise, step_noise = _jax_noise(key, SHAPE, T)
    jkw = dict(cond=jnp.asarray(cond), cond_fn=jcond_fn)
    kw = dict(cond=torch.from_numpy(cond), noise=torch.from_numpy(noise))
    if sampler == "dpm++":
        jkw["noise"] = jnp.asarray(noise)
        ref = jdpm.dpm_solver_pp_loop(jd, jsmooth_model, SHAPE, key, steps=6, **jkw)
        run = lambda **g: d.dpm_solver_pp_loop(smooth_model, SHAPE, steps=6, **kw, **g)  # noqa: E731
    elif sampler == "ddpm":
        ref = jd.p_sample_loop(jsmooth_model, SHAPE, key, **jkw)
        run = lambda **g: d.p_sample_loop(  # noqa: E731
            smooth_model, SHAPE, step_noise=torch.from_numpy(step_noise), **kw, **g)
    else:
        eta = 0.5 if sampler == "ddim_eta" else 0.0
        ref = jd.ddim_sample_loop(jsmooth_model, SHAPE, key, eta=eta, **jkw)
        run = lambda **g: d.ddim_sample_loop(  # noqa: E731
            smooth_model, SHAPE, step_noise=torch.from_numpy(step_noise), eta=eta, **kw, **g)
    with torch.no_grad():
        ours = run(cond_fn=cond_fn)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-5)
    assert float((ours - run()).abs().max()) > 1e-3


def test_cond_fn_may_differentiate_under_no_grad():
    """The loops call ``cond_fn`` with autograd on, so a guide that takes
    the gradient of a log-likelihood itself works inside a ``no_grad``
    loop and equals the analytic gradient."""
    d, _ = _diffusions()

    def autograd_cond_fn(x, t):
        x = x.detach().requires_grad_(True)
        log_p = -0.5 * ((x - 0.3) ** 2).sum()
        return 0.5 * torch.autograd.grad(log_p, x)[0]

    kw = dict(cond=torch.from_numpy(np.random.default_rng(7).random(COND).astype(np.float32)),
              noise=torch.from_numpy(_rand(8, SHAPE)), eta=0.0)
    with torch.no_grad():
        ours = d.ddim_sample_loop(smooth_model, SHAPE, cond_fn=autograd_cond_fn, **kw)
    np.testing.assert_allclose(ours.numpy(),
                               d.ddim_sample_loop(smooth_model, SHAPE, cond_fn=cond_fn, **kw).numpy(),
                               atol=1e-6)


class _Smooth(torch.nn.Module):
    """make_synthesis_fn's model: the smooth x0-predictor with one
    parameter, NCDHW in and out."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(0.7))

    def forward(self, x, t):
        tt = t.float().reshape(-1, 1, 1, 1, 1)
        return torch.tanh(self.a * x[:, :8] + 0.005 * tt) * 0.8


class _JSmooth(fnn.Module):
    @fnn.compact
    def __call__(self, x, t):
        a = self.param("a", lambda key: jnp.float32(0.7))
        tt = jnp.asarray(t, jnp.float32).reshape(-1, 1, 1, 1, 1)
        return jnp.tanh(a * x[..., :8] + 0.005 * tt) * 0.8


def test_make_synthesis_fn_chunk_values_agree_with_jax():
    """A 250-step ddpm chain ("auto" chunks it at 100, as JAX's does):
    every ``chunk`` gives the same image bit for bit, on JAX's noise and on
    a generator's, and the image matches JAX's ``make_synthesis_fn``
    (chunked at 100) at atol 1e-4."""
    steps = 250
    d, jd = _diffusions(steps)
    rng = np.random.default_rng(9)
    vols = {m: rng.random((1, 8, 8, 8, 1)).astype(np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :2] = 0.0
    key = jax.random.PRNGKey(13)
    jrun = jcommon.make_synthesis_fn(_JSmooth(), {"a": jnp.float32(0.7)}, jd, crop_z=8)
    ref = jrun(jcommon.prepare_condition(vols, "t1c"), vols["t1n"], key)
    noise, step_noise = _jax_noise(key, (1, 4, 4, 4, 8), steps)
    cond = common.prepare_condition(vols, "t1c", device="cpu")
    outs, drawn = [], []
    for chunk in ("auto", None, 7, steps):
        run = common.make_synthesis_fn(_Smooth(), d, crop_z=8, chunk=chunk, device="cpu")
        assert run.chain is None
        outs.append(run(cond, vols["t1n"], noise=noise, step_noise=step_noise))
        drawn.append(run(cond, vols["t1n"], torch.Generator().manual_seed(1)))
    for o, g in zip(outs[1:], drawn[1:]):
        assert np.array_equal(o, outs[0]) and np.array_equal(g, drawn[0])
    assert outs[0].shape == ref.shape == (1, 8, 8, 8) and outs[0].max() > 0.0
    np.testing.assert_allclose(outs[0], ref, atol=1e-4)


def test_make_synthesis_fn_refuses_mesh_and_cpu_graphs():
    d, _ = _diffusions()
    # a mesh with an sp axis needs as many ranks: one process cannot build it
    with pytest.raises(ValueError, match="not divisible by sp"):
        common.make_synthesis_fn(_Smooth(), d, device="cpu", mesh=make_mesh(data=-1, sp=2))
    # an sp mesh's chain is eager: its collectives cannot be captured
    sp_mesh = DataMesh({"data": 1, "sp": 2}, None, 0, SpAxis(None, 2, 0))
    with pytest.raises(ValueError, match="cannot be captured in a CUDA graph"):
        common.make_synthesis_fn(_Smooth(), d, device="cpu", mesh=sp_mesh, cuda_graph=True)
    with pytest.raises(ValueError, match="cuda_graph=True needs a CUDA device"):
        common.make_synthesis_fn(_Smooth(), d, device="cpu", cuda_graph=True)
    with pytest.raises(ValueError, match="sampler"):
        graph.CapturedChain(d, smooth_model, "plms")


class _EagerStep:
    """StepGraph's contract (static buffers filled per call, the step run on
    them) without a CUDA graph, so the chain's host logic runs on the CPU."""

    def __init__(self, step, inputs):
        self.step = step
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}

    def __call__(self, **feed):
        for k, v in feed.items():
            self.inputs[k].copy_(v)
        return tuple(t.clone() for t in self.step(**self.inputs))


@pytest.mark.parametrize("sampler,chunk", [("ddpm", None), ("ddpm", 4), ("ddim", None),
                                           ("dpm++", None)])
def test_captured_chain_feeds_what_the_eager_loop_computes(monkeypatch, sampler, chunk):
    """The captured chain's host loop (timesteps, per-step noise drawn ahead
    in segments of ``chunk``, solver coefficients, previous x0, the static
    buffers) with the step run eagerly in place of the graph: the eager
    loop's result bit for bit on the same generator seed and on given
    noise; a new shape builds a new step."""
    monkeypatch.setattr(graph, "StepGraph", _EagerStep)
    d, _ = _diffusions()
    cond = torch.from_numpy(np.random.default_rng(10).random(COND).astype(np.float32))
    chain = graph.CapturedChain(d, smooth_model, sampler, steps=6)
    loops = {"ddpm": d.p_sample_loop, "ddim": d.ddim_sample_loop}
    for gen_seed in (3, None):
        g = torch.Generator().manual_seed(gen_seed) if gen_seed else None
        noise = None if gen_seed else torch.from_numpy(_rand(11, SHAPE))
        step_noise = None if gen_seed or sampler != "ddpm" else torch.from_numpy(
            np.stack([_rand(20 + k, SHAPE) for k in range(T)]))
        ours = chain(SHAPE, cond=cond, noise=noise, step_noise=step_noise,
                     generator=g, chunk=chunk)
        g = torch.Generator().manual_seed(gen_seed) if gen_seed else None
        if sampler == "dpm++":
            ref = d.dpm_solver_pp_loop(smooth_model, SHAPE, cond=cond, noise=noise, steps=6,
                                       generator=g)
        else:
            ref = loops[sampler](smooth_model, SHAPE, cond=cond, noise=noise,
                                 step_noise=step_noise, generator=g)
        assert torch.equal(ours, ref)
    first = chain.graph
    chain((1, *SHAPE[1:]), cond=cond[:1], generator=torch.Generator().manual_seed(1))
    assert chain.graph is not first


def test_haar_clamp_project_constants_are_cached_and_unchanged():
    """The mixing matrix and scale vector are built once per (device,
    dtype); the result is bit for bit the former per-call construction's,
    and matches the JAX package's."""
    x = torch.from_numpy(_rand(12, (2, 3, 4, 5, 8)) * 0.6 + 0.2)
    wv._clamp_constants.cache_clear()
    ours = wv.haar_clamp_project(x)
    m = torch.as_tensor(wv._haar_mixing_matrix(), dtype=x.dtype)
    s = torch.tensor([wv.LLL_SCALE, 1, 1, 1, 1, 1, 1, 1], dtype=x.dtype)
    before = (torch.clamp((x * s) @ m, 0.0, 1.0) @ m.T) / s
    assert torch.equal(ours, before)
    assert torch.equal(wv.haar_clamp_project(x), ours)
    info = wv._clamp_constants.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jwv.haar_clamp_project(jnp.asarray(x.numpy()))),
                               atol=1e-6)


def test_devtime_result_keys():
    """On a machine without a card nothing runs on a device: the keys of
    the result, device time 0.0, and the wall time of the traced calls."""
    calls = []
    res = devtime.devtime(lambda a: calls.append(a) or torch.ones(4) * a, 2.0, iters=2,
                          detail=True)
    assert set(res) == {"total_ms", "wall_ms", "busy_share", "ops"}
    assert len(calls) == 3 and res["wall_ms"] > 0.0
    if not torch.cuda.is_available():
        assert res["total_ms"] == 0.0 and res["busy_share"] == 0.0 and res["ops"] == {}
    assert set(devtime.devtime(lambda: None, iters=1)) == {"total_ms", "wall_ms", "busy_share"}


def test_step_timer_report_equals_jax():
    ours, ref = profiling.StepTimer(), jprofiling.StepTimer()
    for timer in (ours, ref):
        timer.acc.update(data=0.125, step=1.5, log=0.004, save=2.25)
    assert ours.report(42) == ref.report(42)
    assert ours.acc == dict.fromkeys(profiling.StepTimer.PHASES, 0.0)
    with ours.phase("step"):
        pass
    assert ours.acc["step"] >= 0.0 and ours.report(1).startswith("[PROFILE] Step 1: Data=0.00s")


def test_trace_is_gated_on_the_trace_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("FAST_CWDM_TRACE_DIR", raising=False)
    with profiling.trace("off"):
        torch.ones(3).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("FAST_CWDM_TRACE_DIR", str(tmp_path))
    with profiling.trace("chain"), profiling.annotate("step"):
        torch.ones(3).sum()
    with open(tmp_path / "chain" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "step" for e in events)
    assert os.listdir(tmp_path) == ["chain"]


def test_launch_counts_reads_and_sets_every_wrapper_counter():
    """One view of the wrappers' counters, which the captured chain uses to
    count a replay as the captured step's launches."""
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

    saved = ops.launch_counts()
    try:
        want = {k: i + 1 for i, k in enumerate(saved)}
        ops.set_launch_counts(want)
        assert ops.launch_counts() == want
        got = (wc.haar_dwt3.launches, wc.haar_idwt3.launches, ec.affine_silu.launches,
               ec.affine_silu_bwd.launches, tc.conv3d_fused.launches_k4a,
               tc.conv3d_fused.launches_k4b, tc.conv3d_fused_v4.launches,
               *tc.kernel_launches.values())
        assert got == tuple(range(1, len(want) + 1))
        ops.set_launch_counts({"affine_silu": 0})
        assert ec.affine_silu.launches == 0 and wc.haar_dwt3.launches == 1
    finally:
        ops.set_launch_counts(saved)
