"""``GaussianDiffusion.fuse_clip_projection``, ``create`` and ``replace``
against the JAX package (``fast_cwdm_tpu/diffusion/gaussian.py``).

With ``fuse_clip_projection=False`` the x0 projection is the reference's
full-spatial IDWT → clamp → DWT every step, even for an 8-channel Haar
latent (``bench.py``'s faithful leg). The port runs its plain path here;
on the card the same call takes K2 and K1.

Tolerances: the projection 1e-5 (``tests/test_diffusion.py:479-490``); the
10-step chain against JAX 1e-4 (``tests/test_torch_diffusion.py``); the
golden trace 5e-5 per step, as that file replays it; under sp 2 the
unsharded chain's 1e-5 (``tests/test_torch_spatial.py``).
"""

import json
import os
import textwrap

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
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.diffusion import respace
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.parallel import dryrun
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "diffusion_trace_torch.npz")
# the golden chain's tiny reference UNet (tests/test_torch_diffusion.py)
TRACE_CFG = dict(
    image_size=16, in_channels=16, model_channels=16, out_channels=8,
    num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2), dims=3,
    num_groups=8, resblock_updown=True, bottleneck_attention=False, resample_2d=False,
)
CHAIN_CFG = dict(TRACE_CFG, in_channels=32)
SCHEDULES = [("linear", 100, "direct"), ("linear", 10, "sampled")]


def _last(a):
    return np.transpose(a, (0, 2, 3, 4, 1))


def _model_fn(model):
    def fn(x, t):
        return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)
    return fn


def _seeded(cfg):
    model = UNetModel(**cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval(), sd


@pytest.mark.parametrize("channels", [8, 16])
def test_unfused_projection_matches_jax_and_the_fused_one(channels):
    """``replace(fuse_clip_projection=False)._process_xstart`` against
    JAX's (both settings) and the port's fused one, (2, 8, 8, 8, C). At C
    = 16 (two image channels) every setting takes the unfused path."""
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 8, channels)).astype(np.float32)
    ours = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    ref = JGaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    slow = ours.replace(fuse_clip_projection=False)
    assert ours.fuse_clip_projection and not slow.fuse_clip_projection
    got = slow._process_xstart(torch.from_numpy(x), clip_denoised=True).numpy()
    for fuse in (True, False):
        want = np.asarray(ref.replace(fuse_clip_projection=fuse)._process_xstart(
            jnp.asarray(x), clip_denoised=True))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"JAX fuse={fuse}")
    fused = ours._process_xstart(torch.from_numpy(x), clip_denoised=True).numpy()
    np.testing.assert_allclose(got, fused, atol=1e-5)
    assert np.abs(got - x).max() > 1e-2  # the clamp did something


@pytest.mark.parametrize("name,steps,sched", SCHEDULES)
def test_create_matches_jax(name, steps, sched):
    """``create`` builds every table of JAX's ``create`` and the same
    configuration, ``fuse_clip_projection`` True."""
    betas = jschedules.get_named_beta_schedule(name, steps, sched)
    ours, ref = GaussianDiffusion.create(betas), JGaussianDiffusion.create(betas)
    assert set(GaussianDiffusion.TABLES) | set(GaussianDiffusion.CONFIG) == set(
        ref.__dataclass_fields__)
    for tab in GaussianDiffusion.TABLES:
        np.testing.assert_array_equal(getattr(ours, tab), getattr(ref, tab), err_msg=tab)
    for field in GaussianDiffusion.CONFIG:
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.fuse_clip_projection is True


def test_replace_keeps_the_original_and_the_spaced_fields():
    """A spaced diffusion's ``replace``: the copy has the change and every
    other field of the original, which is left as it was (JAX's too)."""
    use = respace.space_timesteps(100, "10")
    betas = jschedules.get_named_beta_schedule("linear", 100, "direct")
    ours = respace.create_spaced_diffusion(use_timesteps=use, betas=betas, mode="i2i")
    ref = jrespace.create_spaced_diffusion(use_timesteps=use, betas=betas, mode="i2i")
    new, jnew = (d.replace(fuse_clip_projection=False) for d in (ours, ref))
    assert type(new) is respace.SpacedDiffusion
    assert set(respace.SpacedDiffusion.TABLES) | set(respace.SpacedDiffusion.CONFIG) == set(
        ref.__dataclass_fields__)
    assert ours.fuse_clip_projection is True and ref.fuse_clip_projection is True
    assert new.fuse_clip_projection is False and jnew.fuse_clip_projection is False
    for field in respace.SpacedDiffusion.CONFIG:
        if field != "fuse_clip_projection":
            assert getattr(new, field) == getattr(ours, field) == getattr(jnew, field), field
    for tab in respace.SpacedDiffusion.TABLES:
        np.testing.assert_array_equal(getattr(new, tab), np.asarray(getattr(jnew, tab)))
        assert getattr(new, tab) is getattr(ours, tab), tab
    t = torch.arange(10)
    np.testing.assert_array_equal(new.scale_timesteps(t).numpy(), np.asarray(ref.timestep_map))


def test_replace_refuses_an_unknown_field():
    """As ``dataclasses.replace``: ``TypeError``, here and in JAX."""
    ours = GaussianDiffusion.named("linear", 10, "sampled")
    with pytest.raises(TypeError):
        JGaussianDiffusion.named("linear", 10, "sampled").replace(fuse_projection=False)
    with pytest.raises(TypeError, match="fuse_projection"):
        ours.replace(fuse_projection=False)
    spaced = respace.create_spaced_diffusion(use_timesteps={0, 5}, betas=ours.betas)
    with pytest.raises(TypeError, match="timestep_mapping"):
        spaced.replace(timestep_mapping=[0, 5])


def test_replace_betas_drops_its_device_copy():
    """On a diffusion whose tables are already on a device, ``replace(betas=…)``
    extracts the new table; the other tables' device copies are shared and
    the original still serves its own."""
    d = GaussianDiffusion.named("linear", 10, "sampled")
    t = torch.tensor([0, 3, 9])
    old = d._extract("betas", t, 1).clone()
    d._extract("alphas_cumprod", t, 1)
    new_betas = np.linspace(0.01, 0.5, 10)
    d2 = d.replace(betas=new_betas)
    np.testing.assert_array_equal(d2._extract("betas", t, 1).numpy(),
                                  new_betas.astype(np.float32)[[0, 3, 9]])
    np.testing.assert_array_equal(d._extract("betas", t, 1).numpy(), old.numpy())
    dev = torch.device("cpu")
    assert d2._on_device[("alphas_cumprod", dev)] is d._on_device[("alphas_cumprod", dev)]
    assert d2._on_device[("betas", dev)] is not d._on_device[("betas", dev)]


def test_create_and_named_refuse_fuse_clip_projection():
    """JAX's ``create`` has no ``fuse_clip_projection`` keyword, so neither
    ``create``, ``named`` nor ``create_spaced_diffusion`` takes it."""
    betas = jschedules.get_named_beta_schedule("linear", 10, "sampled")
    for mod in ((GaussianDiffusion, respace), (JGaussianDiffusion, jrespace)):
        cls, rsp = mod
        with pytest.raises(TypeError):
            cls.create(betas, fuse_clip_projection=False)
        with pytest.raises(TypeError):
            cls.named("linear", 10, "sampled", fuse_clip_projection=False)
        with pytest.raises(TypeError):
            rsp.create_spaced_diffusion(use_timesteps={0, 5}, betas=betas,
                                        fuse_clip_projection=False)


def test_tables_stay_host_numpy():
    """After ``tests/test_diffusion.py``'s guard: every table of a created,
    a spaced and a replaced diffusion is host numpy in its dtype, whatever
    ``replace`` was given."""
    betas = jschedules.get_named_beta_schedule("linear", 100)
    d = GaussianDiffusion.create(betas)
    sd = respace.create_spaced_diffusion(use_timesteps=respace.space_timesteps(100, [10]),
                                         betas=betas)
    replaced = sd.replace(betas=torch.linspace(0.01, 0.5, 10, dtype=torch.float64),
                          timestep_map=list(range(0, 100, 10)))
    for obj in (d, sd, replaced):
        for name, dtype in type(obj).TABLES.items():
            v = getattr(obj, name)
            assert isinstance(v, np.ndarray) and v.dtype == dtype, (type(obj).__name__, name)


def test_unfused_chain_matches_jax():
    """A 10-step sampled i2i ddpm chain with ``fuse_clip_projection=False``,
    the same weights and JAX's noise: the port within 1e-4 of JAX, and of
    its own fused-projection chain."""
    model, sd = _seeded(CHAIN_CFG)
    jmodel = JUNetModel(**CHAIN_CFG)
    params = torch_to_flax(sd, jmodel)
    cond = np.random.default_rng(0).random((1, 8, 8, 8, 24)).astype(np.float32)
    shape = (1, 8, 8, 8, 8)
    key = jax.random.PRNGKey(42)
    jdiff = JGaussianDiffusion.named("linear", 10, "sampled", mode="i2i").replace(
        fuse_clip_projection=False)
    ref = jax.jit(lambda p, c: jdiff.p_sample_loop(
        lambda x, t: jmodel.apply({"params": p}, x, t), shape, key, cond=c))(
        params, jnp.asarray(cond))
    key_init, key_loop = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(key_init, shape, jnp.float32)))
    step_noise = [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
                  for k in jax.random.split(key_loop, 10)]
    fused = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    out = {}
    with torch.no_grad():
        for fuse in (False, True):
            diff = fused.replace(fuse_clip_projection=fuse)
            out[fuse] = diff.p_sample_loop(_model_fn(model), shape, cond=torch.from_numpy(cond),
                                           noise=noise, step_noise=step_noise).numpy()
    np.testing.assert_allclose(out[False], np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(out[False], out[True], atol=1e-4)


def test_golden_chain_with_the_unfused_projection():
    """The executed reference's own chain (its IDWT → clamp → DWT per step),
    replayed step by step with the unfused projection (atol 5e-5)."""
    data = np.load(GOLDEN)
    model = UNetModel(**TRACE_CFG)
    model.load_state_dict({k[3:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("sd.")}, strict=True)
    model.eval()
    diff = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i").replace(
        fuse_clip_projection=False)
    x = torch.from_numpy(_last(data["__x_init__"]))
    cond = torch.from_numpy(_last(data["__cond__"]))
    with torch.no_grad():
        for k, i in enumerate(range(9, -1, -1)):
            t = torch.full((1,), i, dtype=torch.long)
            noise = torch.from_numpy(_last(data["__noises__"][k]))
            x = diff.p_sample(_model_fn(model), x, t, noise, cond=cond)["sample"]
            np.testing.assert_allclose(x.numpy(), _last(data["__steps__"][k]), atol=5e-5,
                                       err_msg=f"diverged at reverse step {k} (t={i})")


SP_CFG = dict(CHAIN_CFG, image_size=8)
_SP_CHILD = """
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from fast_cwdm_tpu_torch.parallel import mesh as pm
pm.setup_distributed("cpu")
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

work, cfg = sys.argv[1], json.loads(sys.argv[2])
inputs = dict(np.load(os.path.join(work, "inputs.npz")))
model = UNetModel(**cfg)
sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
mesh = pm.make_mesh(sp=2)
vols = {m: inputs[m] for m in ("t1n", "t1c", "t2w", "t2f")}
cond = common.prepare_condition(vols, "t1c", device="cpu", mesh=mesh)
diff = GaussianDiffusion.named("linear", 4, "sampled", mode="i2i").replace(
    fuse_clip_projection=False)
run = common.make_synthesis_fn(model.eval(), diff, crop_z=16, mesh=mesh, device="cpu")
img = run(cond, vols["t1n"], noise=inputs["noise"], step_noise=inputs["step_noise"])
np.save(os.path.join(work, f"img{mesh.process_rank}.npy"), img)
print("RESULT " + json.dumps({"rank": mesh.process_rank}), flush=True)
"""


def test_unfused_chain_under_sp_matches_unsharded(tmp_path):
    """Two gloo ranks as one sp group, each with half of Y: the unfused
    projection runs on the Y slab (Haar is block-local). The 4-step ddpm
    image on every rank within 1e-5 of one process's."""
    rng = np.random.default_rng(7)
    inputs = {m: rng.random((1, 16, 16, 16, 1), dtype=np.float32)
              for m in ("t1n", "t1c", "t2w", "t2f")}
    inputs["noise"] = rng.standard_normal((1, 8, 8, 8, 8)).astype(np.float32)
    inputs["step_noise"] = rng.standard_normal((4, 1, 8, 8, 8, 8)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "child.py").write_text(textwrap.dedent(_SP_CHILD))
    procs = dryrun.start_ranks(2, [str(tmp_path / "child.py"), str(tmp_path),
                                   json.dumps(SP_CFG)])
    model, _ = _seeded(SP_CFG)
    vols = {m: inputs[m] for m in ("t1n", "t1c", "t2w", "t2f")}
    cond = common.prepare_condition(vols, "t1c", device="cpu")
    diff = GaussianDiffusion.named("linear", 4, "sampled", mode="i2i")
    one = {}
    for fuse in (False, True):
        run = common.make_synthesis_fn(model, diff.replace(fuse_clip_projection=fuse),
                                       crop_z=16, device="cpu")
        one[fuse] = run(cond, vols["t1n"], noise=inputs["noise"],
                        step_noise=inputs["step_noise"])
    recs = dryrun.results(dryrun.wait_ranks(procs, 240))
    assert sorted(r["rank"] for r in recs) == [0, 1]
    assert one[False].shape == (1, 16, 16, 16) and one[False].max() > 0
    np.testing.assert_allclose(one[False], one[True], atol=1e-5)
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"img{r}.npy"), one[False], atol=1e-5)
