"""The whole slice: the port's synthesis against the JAX package's on the
same weights and noise, the ``cli.sample`` entry point on a tiny NIfTI
tree, and the port's independence from JAX."""

import ast
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.cli import common as jcommon
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu_torch.cli import common, sample
from fast_cwdm_tpu_torch.data.nifti import Nifti1Image, load, save
from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(
    num_channels=16, num_res_blocks=1, channel_mult="1,2", attention_resolutions="",
    num_groups=8, bottleneck_attention=False, image_size=8, resample_2d=False,
    diffusion_steps=10, sample_schedule="sampled", dtype="float32",
)


def _seeded_model(cfg):
    model, diffusion = common.build_model_and_diffusion(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = seeded_state_dict(shapes)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model, diffusion, sd


def test_synthesis_matches_jax():
    """Condition DWTs, 10 ancestral steps with the fused x0 projection,
    IDWT, clamp, mask and crop — port vs JAX, fp32, with the JAX key
    stream's noise handed to the port. atol 1e-4 on a [0,1] image: ten
    steps of the 5e-5 single-forward tolerance."""
    cfg = common.production_config(**TINY)
    model, diffusion, sd = _seeded_model(cfg)
    jmodel, jdiff = jcommon.build_model_and_diffusion(jcommon.production_config(**TINY))
    params = torch_to_flax(sd, jmodel)

    rng = np.random.default_rng(0)
    vols = {m: rng.random((1, 16, 16, 16, 1)).astype(np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :4] = 0.0  # background the mask zeroes
    key = jax.random.PRNGKey(3)
    jcond = jcommon.prepare_condition(vols, "t1c")
    ref = jcommon.make_synthesis_fn(jmodel, params, jdiff, crop_z=12)(jcond, vols["t1n"], key)

    cond = common.prepare_condition(vols, "t1c", device="cpu")
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=1e-5)
    shape = (1, 8, 8, 8, 8)
    key_init, key_loop = jax.random.split(key)
    noise = np.array(jax.random.normal(key_init, shape, jnp.float32))
    step_noise = np.stack([np.array(jax.random.normal(k, shape, jnp.float32))
                           for k in jax.random.split(key_loop, 10)])
    run = common.make_synthesis_fn(model, diffusion, crop_z=12, device="cpu")
    ours = run(cond, vols["t1n"], noise=noise, step_noise=step_noise)
    assert ours.shape == ref.shape == (1, 16, 16, 12)
    assert np.all(ours[:, :4] == 0.0)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("sampler,fuse_conv", [("ddim", False), ("ddim", True), ("dpm++", True)])
def test_samplers_match_jax(sampler, fuse_conv):
    """make_synthesis_fn with the ddim and dpm++ samplers, port vs JAX on
    the same weights and initial noise (eta 0: no per-step noise), fp32,
    image atol 1e-4; fuse_conv on both sides where set (the JAX model's
    XLA fallback off the TPU, the port's plain version of K4b)."""
    cfg = common.production_config(**TINY, fuse_conv=fuse_conv)
    model, diffusion, sd = _seeded_model(cfg)
    assert any(getattr(m, "fuse", False) for m in model.modules()) == fuse_conv
    jmodel, jdiff = jcommon.build_model_and_diffusion(jcommon.production_config(**TINY))
    jmodel = jmodel.clone(fuse_conv=fuse_conv)
    params = torch_to_flax(sd, jmodel)

    rng = np.random.default_rng(1)
    vols = {m: rng.random((1, 16, 16, 16, 1)).astype(np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :4] = 0.0
    key = jax.random.PRNGKey(5)
    steps = 4 if sampler == "dpm++" else None
    ref = jcommon.make_synthesis_fn(jmodel, params, jdiff, crop_z=12, sampler=sampler,
                                    sampler_steps=steps)(
        jcommon.prepare_condition(vols, "t1c"), vols["t1n"], key)
    shape = (1, 8, 8, 8, 8)
    # dpm++ draws its latent from the key itself, ddim from the first split
    init_key = key if sampler == "dpm++" else jax.random.split(key)[0]
    noise = np.array(jax.random.normal(init_key, shape, jnp.float32))
    run = common.make_synthesis_fn(model, diffusion, crop_z=12, sampler=sampler,
                                   sampler_steps=steps, device="cpu")
    ours = run(common.prepare_condition(vols, "t1c", device="cpu"), vols["t1n"], noise=noise)
    assert ours.shape == ref.shape == (1, 16, 16, 12)
    assert np.all(ours[:, :4] == 0.0) and ours.max() > 0.0
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def _make_case(case_dir, shape=(24, 24, 15), seed=0):
    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = os.path.basename(case_dir)
    for m in ("t1n", "t1c", "t2w", "t2f"):
        vol = (rng.random(shape) * 900 + 100).astype(np.float32)
        vol[:4] = 0.0
        save(Nifti1Image(vol, np.eye(4)), os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))


def _tiny_flags(tmp_path):
    cfg = common.production_config(**TINY)
    model, _, sd = _seeded_model(cfg)
    weights = str(tmp_path / "brats_t1c_BEST_sampled_10.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights)
    data = tmp_path / "data"
    _make_case(str(data / "00001"))
    return [f"--{k}={v}" for k, v in cfg.items()] + [
        f"--data_dir={data}", f"--model_path={weights}", "--contr=t1c",
        f"--output_dir={tmp_path / 'out'}",
    ]


def test_cli_sample_on_cpu(tmp_path):
    flags = _tiny_flags(tmp_path)
    timings = sample.main(flags + ["--device=cpu"])
    assert len(timings) == 1
    out = load(str(tmp_path / "out" / "00001" / "sample.nii.gz")).get_fdata()
    # 24×24 → crop 8 per side; Z padded to 160, cropped back to 155
    assert out.shape == (8, 8, 155)
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    assert np.all(out[:, :, 15:] == 0.0)  # the padded slices are background
    assert out.max() > 0.0
    assert (tmp_path / "out" / "00001" / "target.nii.gz").exists()


def test_cli_sample_fused_conv_dpm_on_cpu(tmp_path):
    """The flags of the fused-conv DPM-Solver++ serving path reach the
    model and the sampler."""
    flags = _tiny_flags(tmp_path) + ["--device=cpu", "--fuse_conv=True", "--sampler=dpm++",
                                     "--sampling_steps=3"]
    sample.main(flags)
    out = load(str(tmp_path / "out" / "00001" / "sample.nii.gz")).get_fdata()
    assert out.shape == (8, 8, 155)
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0 and out.max() > 0.0


def test_entry_points_refuse_to_fall_back_to_cpu(tmp_path):
    """With no GPU, an entry point called without ``device`` raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    cfg = common.production_config(**TINY)
    model, diffusion = common.build_model_and_diffusion(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        common.make_synthesis_fn(model, diffusion)
    with pytest.raises(RuntimeError, match="no GPU"):
        common.prepare_condition({m: np.zeros((1, 4, 4, 4, 1)) for m in ("t1n", "t2w", "t2f")}, "t1c")
    with pytest.raises(RuntimeError, match="no GPU"):
        diffusion.p_sample_loop(lambda x, t: x, (1, 2, 2, 2, 8))
    with pytest.raises(RuntimeError, match="no GPU"):
        sample.main(_tiny_flags(tmp_path))
    assert not (tmp_path / "out").exists()


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "fast_cwdm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "msgpack", "fast_cwdm_tpu", "orbax",
                                "tensorstore", "zstandard"), (f, mod)


def test_unported_samplers_and_formats_raise(tmp_path):
    """Both backends of the JAX package load (.ckpt and .orbax, the same
    weights from either); a missing .orbax raises FileNotFoundError and a
    corrupt one the ValueError of JAX's layout probe."""
    cfg = common.production_config(**TINY)
    model, diffusion = common.build_model_and_diffusion(cfg)
    params = jax_params_from_state_dict(model.state_dict(), model)
    for ext in (".ckpt", ".orbax"):
        ckpt.save_checkpoint(str(tmp_path / f"x{ext}"), {"params": params, "ema_params": (),
                                                         "step": 0})
    a, _ = common.build_model_and_diffusion(cfg)
    b, _ = common.build_model_and_diffusion(cfg)
    common.load_params(str(tmp_path / "x.ckpt"), a)
    common.load_params(str(tmp_path / "x.orbax"), b)
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    assert all(torch.equal(a.state_dict()[k], v) for k, v in model.state_dict().items())
    with pytest.raises(FileNotFoundError):
        common.load_params(str(tmp_path / "missing.orbax"), model)
    (tmp_path / "x.orbax" / "_METADATA").write_text("{not json")
    with pytest.raises(ValueError, match="incompatible checkpoint layout"):
        common.load_params(str(tmp_path / "x.orbax"), model)
