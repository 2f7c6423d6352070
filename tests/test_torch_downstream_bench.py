"""The port's downstream bench (``fast_cwdm_tpu_torch/scripts/downstream_bench.py``):
the harness tests of tests/test_downstream_bench.py run against the port's
module, and the model-free ``real`` leg and GT region means of both
packages' benches, equal on the same phantom val tree."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from fast_cwdm_tpu_torch.data import nifti
from fast_cwdm_tpu_torch.scripts import downstream_bench as db

torch.set_num_threads(2)

_JDB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "scripts", "downstream_bench.py")


def _jax_db():
    spec = importlib.util.spec_from_file_location("jax_downstream_bench", _JDB_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(tmp_path, **over):
    base = {"workdir": str(tmp_path / "wd"), "val_dir": str(tmp_path / "val"),
            "checkpoint_dir": str(tmp_path / "ckpt")}
    base.update(over)
    return db.parse_args([f"--{k}={v}" for k, v in base.items()])


def _fake_val(tmp_path, cases=("00000", "00001")):
    """A val tree with 4 modalities + seg per case (placeholder files:
    stage_incomplete only copies)."""
    val = tmp_path / "val"
    for c in cases:
        d = val / c
        d.mkdir(parents=True)
        for m in ("t1n", "t1c", "t2w", "t2f", "seg"):
            (d / f"BraTS-GLI-{c}-000-{m}.nii.gz").write_bytes(b"x")
    (val / ".complete").write_bytes(b"")
    return str(val)


def test_stage_incomplete_drops_only_target_modality(tmp_path):
    a = _args(tmp_path)
    _fake_val(tmp_path)
    os.makedirs(a.workdir, exist_ok=True)
    out = db.stage_incomplete(a)
    for c in ("00000", "00001"):
        files = sorted(os.listdir(os.path.join(out, c)))
        assert not any("-t1c." in f for f in files), files
        assert len([f for f in files if f.endswith(".nii.gz")]) == 4
    assert sorted(os.listdir(out)) == [".complete", "00000", "00001"]


def test_stage_incomplete_resumes_on_marker(tmp_path):
    a = _args(tmp_path)
    _fake_val(tmp_path)
    os.makedirs(a.workdir, exist_ok=True)
    out = db.stage_incomplete(a)
    victim = os.path.join(out, "00000")
    for f in os.listdir(victim):
        os.remove(os.path.join(victim, f))
    assert db.stage_incomplete(a) == out
    assert os.listdir(victim) == []


def test_agreement_skips_missing_and_all_empty_pairs(tmp_path):
    a = _args(tmp_path)
    pa, pb = tmp_path / "pa", tmp_path / "pb"
    pa.mkdir(), pb.mkdir()

    def put(d, name, arr):
        nifti.save(nifti.Nifti1Image(arr.astype(np.int16), np.eye(4)), str(d / name))

    lesion = np.zeros((8, 8, 8), np.int16)
    lesion[2:5, 2:5, 2:5] = 3
    put(pa, "c1.nii.gz", lesion)
    put(pb, "c1.nii.gz", lesion)
    put(pa, "c2.nii.gz", np.zeros((8, 8, 8)))
    put(pb, "c2.nii.gz", np.zeros((8, 8, 8)))
    put(pa, "only_a.nii.gz", lesion)
    assert db.agreement(a, str(pa), str(pb)) == 1.0
    assert db.agreement(a, str(pa), str(tmp_path)) is None


def test_main_report_and_md_row(tmp_path, monkeypatch):
    """main() with the heavy stages stubbed: report JSON written, legs keyed
    real/synth_{label}, the device named, the md row appended."""
    md = tmp_path / "OUT.md"
    _fake_val(tmp_path)
    monkeypatch.setattr(db, "stage_complete", lambda a, inc: a.val_dir)
    monkeypatch.setattr(db, "stage_nnunet", lambda a, tree, tag: (tree, tree))

    def fake_segment(a, images, tag):
        d = os.path.join(a.workdir, f"preds_{tag}")
        os.makedirs(d, exist_ok=True)
        return d

    monkeypatch.setattr(db, "stage_segment", fake_segment)
    monkeypatch.setattr(db, "agreement", lambda a, x, y: 0.875)
    monkeypatch.setattr(db, "region_means", lambda a, tree: {"mean": {"et": 0.9}, "cases": {}})
    fake_scores = {"dice_mean": 0.9, "n": 2, "per_case": {},
                   "dice_per_label_mean": {"edema": 0.9, "ncr": 0.9, "et": 0.9}}
    import fast_cwdm_tpu_torch.cli.evaluate_synthesis as ev

    monkeypatch.setattr(ev, "calculate_dice_scores", lambda p, l: dict(fake_scores))
    db.main([f"--workdir={tmp_path / 'wd'}", f"--val_dir={tmp_path / 'val'}",
             f"--checkpoint_dir={tmp_path / 'ckpt'}", "--quick", "--device=cpu", "--sampler=dpm++",
             "--sampling_steps=25", f"--write_md={md}"])
    with open(tmp_path / "wd" / "downstream_dpm++-25.json") as f:
        report = json.load(f)
    assert set(report["legs"]) == {"real", "synth_dpm++-25"}
    assert report["agreement"] == 0.875 and report["device"] == "cpu"
    assert report["legs"]["synth_dpm++-25"]["region_means"]["mean"]["et"] == 0.9
    assert report["gt_region_means"] == {"et": 0.9}
    line = md.read_text().strip()
    assert line.startswith("| downstream Dice (dpm++-25) |")
    assert "prediction agreement 0.8750" in line


def test_downstream_bench_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    _fake_val(tmp_path)
    for extra in ([], ["--quick"]):  # --quick does not move the run to the CPU
        with pytest.raises(RuntimeError, match="no GPU"):
            db.main([f"--workdir={tmp_path / 'wd'}", f"--val_dir={tmp_path / 'val'}",
                     f"--checkpoint_dir={tmp_path / 'ckpt'}"] + extra)
        assert not (tmp_path / "wd").exists()


def test_model_free_legs_match_jax(tmp_path):
    """Both packages' benches on the same phantom val tree (seeds 10000,
    10001 at the --quick shape, with --with_control): the real leg (layout,
    segmenter, Dice), the control leg (the completion chain's intensity
    round trip, no model) and the GT region means are equal; the synth legs
    run the same tiny JAX-written checkpoint through each package's
    completion and are only checked for shape."""
    from fast_cwdm_tpu.cli import common as jcommon
    from fast_cwdm_tpu.training import bridge
    from fast_cwdm_tpu.training import checkpoints as jckpt
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.data.phantom import write_phantom_dataset
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    val = str(tmp_path / "val")
    write_phantom_dataset(val, 2, start_seed=10_000, shape=(40, 40, 26), workers=2)
    cfg = common.production_config(
        num_channels=16, num_res_blocks=1, channel_mult="1,2", num_groups=8, image_size=8,
        dtype="float32", sample_schedule="sampled", diffusion_steps=4)
    model, _ = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    jmodel, _ = jcommon.build_model_and_diffusion(cfg)
    params = bridge.torch_to_flax(sd, jmodel)
    ckpt_dir = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(os.path.join(ckpt_dir, jckpt.best_checkpoint_name("t1c", "sampled", 4)),
                          {"params": params, "ema_params": (params,), "step": 4},
                          config={**cfg, "contr": "t1c"})
    argv = [f"--val_dir={val}", f"--checkpoint_dir={ckpt_dir}", "--quick", "--sampler=ddpm",
            "--sampling_steps=4", "--with_control"]
    ours = db.main([f"--workdir={tmp_path / 'ours'}", "--device=cpu"] + argv)
    _jax_db().main([f"--workdir={tmp_path / 'ref'}"] + argv)
    with open(tmp_path / "ref" / "downstream_ddpm-4.json") as f:
        ref = json.load(f)
    ours = json.loads(json.dumps(ours))  # the report as written: nan → NaN, tuples → lists
    assert ours["legs"]["real"]["n"] == 2 and ours["legs"]["real"]["dice_mean"] > 0
    assert ours["legs"]["real"] == ref["legs"]["real"]
    assert ours["legs"]["control"] == ref["legs"]["control"]
    assert ours["gt_region_means"] == ref["gt_region_means"]
    assert ours["legs"]["synth_ddpm-4"]["n"] == ref["legs"]["synth_ddpm-4"]["n"] == 2
