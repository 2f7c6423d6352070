"""The port's probes (``fast_cwdm_tpu_torch/scripts/probe_*.py``) on the
CPU at tiny sizes: tests/test_probe_regression.py's harness tests against
the port's script, the lane probe's fold against the JAX script's bit for
bit, ``x0_pred`` and the regression's ``loss_fn`` and ``predict`` against
the same formulas built from JAX package calls on the same weights and
noise, the regression checkpoint across the two packages, and each probe's
``main`` end to end (its device times are 0.0 here: no card)."""

import importlib.util
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.cli import common as jcommon
from fast_cwdm_tpu.data import brats as jbrats
from fast_cwdm_tpu.diffusion.gaussian import condition_order as jcondition_order
from fast_cwdm_tpu.ops import wavelet as jwv
from fast_cwdm_tpu.training import checkpoints as jckpt
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.data import brats
from fast_cwdm_tpu_torch.data.phantom import write_phantom_dataset
from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.scripts import probe_batch2 as pb
from fast_cwdm_tpu_torch.scripts import probe_core_inference as pci
from fast_cwdm_tpu_torch.scripts import probe_elementwise as pe
from fast_cwdm_tpu_torch.scripts import probe_lane_ceiling as pl
from fast_cwdm_tpu_torch.scripts import probe_regression as pr
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(
    num_channels=16, num_res_blocks=1, channel_mult="1,2", attention_resolutions="",
    num_groups=8, bottleneck_attention=False, image_size=8, resample_2d=False,
    diffusion_steps=10, sample_schedule="sampled", dtype="float32",
)
ROW_KEYS = {"label", "ms_per_step", "loss", "peak_gb", "steps", "launches", "source"}
PHANTOM = (40, 40, 26)  # raw geometry of the tiny phantoms (24×24×160 preprocessed)


def _jax_lane_script():
    """The JAX package's lane probe as a module; importing it points JAX's
    compilation cache elsewhere, so the worker's settings are restored."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "jax_probe_lane_ceiling", REPO / "scripts" / "probe_lane_ceiling.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _seeded(cfg):
    """Port and JAX models of ``cfg`` with the same seeded weights."""
    model, diffusion = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jmodel, jdiff = jcommon.build_model_and_diffusion(cfg)
    return model.eval(), diffusion, jmodel, jdiff, torch_to_flax(sd, jmodel)


# --- probe_regression: tests/test_probe_regression.py's harness tests ------


def test_find_matches_modality_tag(tmp_path):
    d = tmp_path / "case"
    d.mkdir()
    (d / "BraTS-GLI-00000-000-t1c.nii.gz").write_bytes(b"x")
    (d / "BraTS-GLI-00000-000-t1n.nii.gz").write_bytes(b"x")
    (d / ".hidden-t1c.nii.gz").write_bytes(b"x")
    found = pr._find(str(d), "t1c")
    assert found is not None and found.endswith("-t1c.nii.gz")
    assert not os.path.basename(found).startswith(".")
    assert pr._find(str(d), "t2w") is None


def test_production_config_keeps_memory_discipline():
    """The probe trains the production model with a pinned dataset, with
    cli/train --remat_max_ds=0's discipline, and the architecture of every
    diffusion run it is compared to (81,511,048 parameters)."""
    cfg = pr.model_config(pr.parse_args(["--workdir", "/tmp/x"]))
    assert cfg["remat_max_ds"] == 0
    assert cfg["use_checkpoint"] is True
    assert cfg["in_channels"] == 32 and cfg["out_channels"] == 8
    assert cfg["num_channels"] == 64
    model, _ = common.build_model_and_diffusion(cfg)
    assert sum(p.numel() for p in model.parameters()) == 81_511_048


def test_quick_config_is_tiny():
    cfg = pr.model_config(pr.parse_args(["--workdir", "/tmp/x", "--quick"]))
    assert cfg["num_channels"] == 16 and cfg["image_size"] == 8


def test_stage_train_skips_on_done_marker(tmp_path):
    """With the .train_done marker present the stage returns the checkpoint
    path without touching data or device (resumable-stage contract)."""
    a = pr.parse_args(["--workdir", str(tmp_path), "--data_dir", "/nonexistent",
                       "--val_dir", "/nonexistent"])
    open(os.path.join(str(tmp_path), ".train_done"), "w").close()
    path = pr.stage_train(a, {}, model=None)  # model unused when skipped
    assert path.endswith("regression.ckpt")


def test_main_requires_dirs_outside_quick(tmp_path):
    with pytest.raises(SystemExit):
        pr.main(["--workdir", str(tmp_path / "x")])


def test_defaults_match_documented_probe_protocol():
    a = pr.parse_args(["--workdir", "/tmp/x"])
    assert a.train_steps == 5000
    assert a.lr == pytest.approx(1e-4)
    assert a.lesion_weight == 0.0 and a.lesion_core_weight == 0.0
    assert a.stages == "train,eval"
    assert a.device == "cuda"


def test_no_default_output_overwrites_a_committed_record():
    """The probes' default ``--out`` names are the port's own: none is a
    file of the repository (the JAX package's PROBE_*_r05.json records)."""
    outs = [pr.parse_args(["--workdir", "w"]).out,
            pci.parse_args(["--checkpoint_dir", "c", "--val_dir", "v"]).out]
    assert all(not (REPO / o).exists() and "_r05" not in o for o in outs), outs


# --- probe_lane_ceiling -------------------------------------------------------


def test_fold_functions_equal_the_jax_scripts_bit_for_bit():
    jl = _jax_lane_script()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 6, 5)).astype(np.float32)
    folded = pl.fold_x(torch.from_numpy(x)).numpy()
    assert folded.tobytes() == np.asarray(jl.fold_x(jnp.asarray(x))).tobytes()
    assert (pl.unfold_x(torch.from_numpy(folded)).numpy().tobytes()
            == np.asarray(jl.unfold_x(jnp.asarray(folded))).tobytes() == x.tobytes())
    w = rng.standard_normal((3, 3, 3, 4, 6)).astype(np.float32)
    assert pl.fold_kernel(w).tobytes() == jl.fold_kernel(w).tobytes()


def test_folded_conv_equals_the_plain_conv():
    """fp32: the X-folded conv with the folded kernel equals the plain conv
    (1e-4), and the plain conv equals JAX's SAME conv (1e-4)."""
    jl = _jax_lane_script()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 8, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 8, 8)) * 0.1).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = pl.conv(xt, wt)
    folded = pl.unfold_x(pl.conv(pl.fold_x(xt), torch.from_numpy(pl.fold_kernel(w))))
    assert float((plain - folded).abs().max()) <= 1e-4
    np.testing.assert_allclose(plain.numpy(), np.asarray(jl.conv(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-4)


def test_lane_probe_runs_on_the_cpu():
    res = pl.main(["--device", "cpu", "--quick"])
    assert set(res) == {f"conv_{ci}->{co}" for ci, co in pl.PAIRS} | {
        "fold_parity_err", "fold_plain_ms", "fold_full_ms", "fold_steady_ms"}
    assert res["fold_parity_err"] < 1e-3


# --- probe_elementwise ---------------------------------------------------------


def test_elementwise_probe_runs_on_the_cpu():
    """Legs A and B at the tiny size; the plain version equals K3's plain
    version bit for bit; C is skipped (no forward win where every device
    time is 0.0)."""
    res = pe.main(["--device", "cpu", "--quick", "--iters", "1"])
    assert set(res["A"]) == {"A/plain_affine_silu", "A/k3_affine_silu"}
    assert set(res["B"]["forward_ms"]) == {"fuse_gn_silu=False", "fuse_gn_silu=True"}
    assert res["C"] is None
    from fast_cwdm_tpu_torch.ops.elementwise_cuda import affine_silu_plain

    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 6, 4, 4, 4), generator=g).to(torch.bfloat16)
    a, b = torch.rand((1, 6), generator=g), torch.randn((1, 6), generator=g)
    assert torch.equal(pe.plain_affine_silu(x, a, b), affine_silu_plain(x, a, b))


# --- probe_batch2 ----------------------------------------------------------------


def test_batch2_legs_and_an_injected_failure(monkeypatch):
    """The four legs at the tiny config: each row's schema; a leg that
    raises is a row that records the error, and the legs after it still
    run."""
    orig = pb.build

    def build(remat_max_ds=1, **kw):
        if remat_max_ds == 0:
            raise RuntimeError("CUDA out of memory (injected)")
        return orig(remat_max_ds, **kw)

    monkeypatch.setattr(pb, "build", build)
    rows = pb.main(["--device", "cpu", "--quick", "--iters", "1"])
    assert [r["label"] for r in rows] == ["batch1", "batch2_accum", "batch2_true_remat_all",
                                         "batch2_true_remat_ds1"]
    assert rows[2] == {"label": "batch2_true_remat_all",
                       "error": "CUDA out of memory (injected)"}
    for r in rows[:2] + rows[3:]:
        assert set(r) == ROW_KEYS and np.isfinite(r["loss"]) and r["launches"] == {}


# --- probe_core_inference ----------------------------------------------------------


def _jax_x0_pred(jmodel, jdiff, params, x0_wav, cond, noise_wav, t, blind):
    """The JAX script's x0_pred: q_sample → p_mean_variance → normalised
    IDWT → clip, from JAX package calls."""
    def model_fn(x, tt, **kw):
        return jmodel.apply({"params": params}, x, tt, **kw).astype(jnp.float32)

    x_t = noise_wav if blind else jdiff.q_sample(x0_wav, t, noise_wav)
    out = jdiff.p_mean_variance(model_fn, x_t, t, cond=cond, clip_denoised=True)
    img = jwv.idwt_normalized(out["pred_xstart"], channels=1, wavelet=jdiff.wavelet)
    return jnp.clip(img, 0.0, 1.0)


@pytest.mark.parametrize("blind", [False, True])
def test_x0_pred_matches_jax(blind):
    """Teacher and blind x0-predictions, port vs JAX on the same weights,
    the same volumes and the same numpy noise, fp32, within 1e-4 (batch 2,
    two timesteps of the 1000-step process)."""
    cfg = pr.model_config(pr.parse_args(["--workdir", "w", "--quick"]))
    model, diffusion, jmodel, jdiff, params = _seeded(cfg)
    rng = np.random.default_rng(0)
    vols = {m: rng.random((2, 16, 16, 16, 1)).astype(np.float32) for m in brats.MODALITIES}
    noise = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    t = [600, 50]
    with torch.inference_mode():
        ours = pci.x0_pred(
            model, diffusion, wv.dwt_normalized(torch.from_numpy(vols["t1c"])),
            torch.cat([wv.dwt_normalized(torch.from_numpy(vols[m]))
                       for m in jcondition_order("t1c")], dim=-1),
            wv.dwt3_flat(torch.from_numpy(noise)), torch.tensor(t), blind=blind).numpy()
    ref = _jax_x0_pred(
        jmodel, jdiff, params, jwv.dwt_normalized(jnp.asarray(vols["t1c"])),
        jnp.concatenate([jwv.dwt_normalized(jnp.asarray(vols[m]))
                         for m in jcondition_order("t1c")], axis=-1),
        jwv.dwt3_flat(jnp.asarray(noise)), jnp.array(t, jnp.int32), blind)
    assert ours.shape == (2, 16, 16, 16, 1)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4)


def _phantoms(root, n, seed0):
    if not os.path.isdir(root):
        write_phantom_dataset(root, n, start_seed=seed0, shape=PHANTOM, workers=2)
    return root


def test_core_inference_probe_end_to_end(tmp_path):
    """main on a tiny BEST and two phantom val cases on the CPU: a teacher
    row per case and t, one blind row at the largest t, finite means; the
    GT rows equal the JAX script's formula (float32 means of its
    ``load_preprocessed`` volumes) within 1e-6; timesteps outside the
    checkpoint's process are refused."""
    val = _phantoms(str(tmp_path / "val"), 2, 10_000)
    cfg = common.production_config(**TINY)
    model, _ = common.build_model_and_diffusion(cfg)
    cdir = tmp_path / "ckpt"
    cdir.mkdir()
    path = str(cdir / ckpt.best_checkpoint_name("t1c", "sampled", 10))
    ckpt.save_checkpoint(path, {"params": jax_params_from_state_dict(model.state_dict(), model),
                                "ema_params": (), "step": 1}, config=cfg)
    out = str(tmp_path / "probe.json")
    argv = ["--checkpoint_dir", str(cdir), "--val_dir", val, "--out", out, "--quick"]
    with pytest.raises(SystemExit, match="outside"):
        pci.main(argv + ["--timesteps", "999"])
    report = pci.main(argv + ["--timesteps", "9", "5", "0"])
    assert json.load(open(out)) == report
    assert [(r["case"], r["t"], r["regime"]) for r in report["rows"]] == [
        (c, t, g) for c in ("10000", "10001")
        for t, g in ((9, "teacher"), (9, "blind"), (5, "teacher"), (0, "teacher"))]
    assert all(np.isfinite(r["healthy_mae"]) for r in report["rows"])
    for row in report["gt"]:
        case_dir = os.path.join(val, row["case"])
        x = jbrats.load_preprocessed(pci._find(case_dir, "t1c"))[..., 0]
        seg = jbrats.load_seg(pci._find(case_dir, "seg"))[..., 0]
        for lbl, name in pci.RAW_REGIONS.items():
            m = seg == lbl
            want = float(x[m].mean()) if m.any() else None
            assert (row[name] is None) == (want is None)
            if want is not None:
                assert abs(row[name] - want) <= 1e-6, (row, name, want)


# --- probe_regression: loss_fn, predict, the checkpoint ---------------------------


def _jax_regression_loss(jmodel, params, vols, seg, contr, lw, lcw):
    """The JAX script's loss_fn (stage_train), from JAX package calls."""
    ti = brats.MODALITIES.index(contr)
    target = vols[..., ti: ti + 1].astype(jnp.float32)
    cond = jnp.concatenate([jwv.dwt_normalized(vols[..., c: c + 1].astype(jnp.float32))
                            for c in (brats.MODALITIES.index(m)
                                      for m in jcondition_order(contr))], axis=-1)
    x0_wav = jwv.dwt_normalized(target)
    x = jnp.concatenate([jnp.zeros_like(x0_wav), cond], axis=-1)
    out = jmodel.apply({"params": params}, x, jnp.zeros((x.shape[0],), jnp.int32)).astype(
        jnp.float32)
    sq = (x0_wav - out) ** 2
    loss = sq.mean(axis=tuple(range(1, sq.ndim - 1))).mean(axis=0).mean()
    terms = {}
    if lw or lcw:
        diff2 = (jwv.idwt_normalized(out, channels=1) - target) ** 2
        axes = tuple(range(1, diff2.ndim))

        def masked_aux(mask):
            return ((diff2 * mask).sum(axes) / jnp.maximum(mask.sum(axes), 1.0)).mean()

        if lw:
            terms["mse_lesion"] = masked_aux((seg > 0).astype(jnp.float32)[..., None])
            loss = loss + lw * terms["mse_lesion"]
        if lcw:
            terms["mse_lesion_core"] = masked_aux((seg == 4).astype(jnp.float32)[..., None])
            loss = loss + lcw * terms["mse_lesion_core"]
    return loss, terms


@pytest.mark.parametrize("lw,lcw", [(0.0, 0.0), (0.5, 0.0), (0.3, 2.0)])
def test_regression_loss_matches_jax(lw, lcw):
    """loss_fn (with and without the lesion and core aux terms) against the
    JAX script's formula on the same weights and batch, fp32, 5e-5."""
    cfg = pr.model_config(pr.parse_args(["--workdir", "w", "--quick"]))
    model, _, jmodel, _, params = _seeded(cfg)
    rng = np.random.default_rng(3)
    vols = rng.random((2, 16, 16, 16, 4)).astype(np.float32)
    seg = rng.choice(np.array([0, 1, 2, 4], np.uint8), size=(2, 16, 16, 16))
    seg[1] = 0  # an empty mask contributes 0
    loss, terms = pr.loss_fn(model, torch.from_numpy(vols), torch.from_numpy(seg), contr="t1c",
                             compute_dtype=torch.float32, lesion_weight=lw,
                             lesion_core_weight=lcw)
    jloss, jterms = _jax_regression_loss(jmodel, params, jnp.asarray(vols), jnp.asarray(seg),
                                         "t1c", lw, lcw)
    assert abs(float(loss.detach()) - float(jloss)) <= 5e-5
    assert set(terms) == {"mse_wav_mean"} | set(jterms)
    for k, v in jterms.items():
        assert abs(float(terms[k]) - float(v)) <= 5e-5, k


def test_regression_predict_matches_jax():
    cfg = pr.model_config(pr.parse_args(["--workdir", "w", "--quick"]))
    model, _, jmodel, _, params = _seeded(cfg)
    cond = np.random.default_rng(4).standard_normal((2, 8, 8, 8, 24)).astype(np.float32)
    with torch.inference_mode():
        ours = pr.predict(model, torch.from_numpy(cond), torch.float32).numpy()
    x = jnp.concatenate([jnp.zeros((2, 8, 8, 8, 8)), jnp.asarray(cond)], axis=-1)
    outw = jmodel.apply({"params": params}, x, jnp.zeros((2,), jnp.int32)).astype(jnp.float32)
    ref = jnp.clip(jwv.idwt_normalized(outw, channels=1), 0.0, 1.0)
    assert ours.shape == (2, 16, 16, 16, 1)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=5e-5)


def test_regression_checkpoint_crosses_packages(tmp_path):
    """The port's regression.ckpt (2 training steps) is read by the JAX
    package's load_checkpoint, equal to the port's weights; a JAX-written
    one (step 5) resumes the port's training, which then ends at step 6
    with the same file format."""
    data = _phantoms(str(tmp_path / "train"), 2, 0)
    base = ["--workdir", str(tmp_path / "wd"), "--data_dir", data, "--val_dir", data,
            "--quick", "--device", "cpu", "--log_interval", "1"]
    a = pr.parse_args(base + ["--train_steps", "2", "--lesion_weight", "0.5"])
    os.makedirs(a.workdir)
    cfg = pr.model_config(a)
    model = pr.build_model(cfg, "cpu")
    path = pr.stage_train(a, cfg, model)
    assert os.path.exists(os.path.join(a.workdir, ".train_done"))
    jmodel, _ = jcommon.build_model_and_diffusion(cfg)
    template = torch_to_flax({k: v.numpy() for k, v in model.state_dict().items()}, jmodel)
    got = jckpt.load_checkpoint(path, {"params": template, "step": np.zeros((), np.int32)})
    assert int(got["step"]) == 2
    want = jax_params_from_state_dict(model.state_dict(), model)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(got["params"]).keys() == flat(want).keys()
    assert all(np.array_equal(v, flat(want)[k]) for k, v in flat(got["params"]).items())

    other = {k: np.asarray(v) * 0.5 for k, v in flat(template).items()}
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, v: other[jax.tree_util.keystr(p)], template)
    jpath = str(tmp_path / "jax_regression.ckpt")
    jckpt.save_checkpoint(jpath, {"params": jparams, "step": np.asarray(5, np.int32)})
    b = pr.parse_args(base + ["--workdir", str(tmp_path / "wd2"), "--train_steps", "6",
                              "--resume", jpath])
    os.makedirs(b.workdir)
    resumed = pr.build_model(cfg, "cpu")
    assert pr._load_weights(resumed, jpath) == 5
    assert all(np.array_equal(v, other[k]) for k, v in flat(
        jax_params_from_state_dict(resumed.state_dict(), resumed)).items())
    path2 = pr.stage_train(b, cfg, resumed)
    again = jckpt.load_checkpoint(path2, {"params": template, "step": np.zeros((), np.int32)})
    assert int(again["step"]) == 6
    final = json.load(open(os.path.join(b.workdir, "train_final.json")))
    assert final["steps"] == 6 and np.isfinite(final["final"]["loss"])
