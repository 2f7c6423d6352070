"""The port's BraSyn evaluation CLIs against the JAX package's on the CPU:
Dice (both means), ``psnr`` and ``ssim3d`` (torch, float64) on seeded
volumes, their errors and the brute-force sliding-window oracle of
tests/test_metrics.py; ``evaluate_cases`` and ``calculate_dice_scores``
reports on a tiny tree; ``drop_modality`` and ``prepare_nnunet_dataset``
output trees file for file; the CLIs' device rule."""

import filecmp
import json
import math
import os

import numpy as np
import pytest
import torch

from fast_cwdm_tpu.cli import drop_modality as jdrop
from fast_cwdm_tpu.cli import evaluate_synthesis as jev
from fast_cwdm_tpu.cli import prepare_nnunet_dataset as jprep
from fast_cwdm_tpu.data import nifti as jnifti
from fast_cwdm_tpu_torch.cli import drop_modality, prepare_nnunet_dataset
from fast_cwdm_tpu_torch.cli import evaluate_synthesis as ev
from fast_cwdm_tpu_torch.data import nifti

torch.set_num_threads(2)

MODALITIES = ("t1n", "t1c", "t2w", "t2f")


def _close(a, b, atol=1e-12):
    """Reports equal key for key; floats within ``atol``, nan == nan."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            _close(a[k], b[k], atol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, atol)
    elif isinstance(a, float):
        assert isinstance(b, float)
        assert (math.isnan(a) and math.isnan(b)) or a == b or abs(a - b) <= atol, (a, b)
    else:
        assert a == b, (a, b)


# --- Dice --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_dice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 5, (9, 8, 7))
    pred = np.where(rng.random(gt.shape) < 0.3, rng.integers(0, 5, gt.shape), gt)
    pred[pred == 3] = 0  # an absent label: nan, skipped by the foreground mean
    for lbl in range(6):
        a, b = ev.dice_score(pred, gt, lbl), jev.dice_score(pred, gt, lbl)
        assert (math.isnan(a) and math.isnan(b)) or a == b
    assert ev.mean_multilabel_dice(pred, gt) == jev.mean_multilabel_dice(pred, gt)
    assert ev.mean_multilabel_dice_ref(pred, gt) == jev.mean_multilabel_dice_ref(pred, gt)
    assert math.isnan(ev.mean_multilabel_dice(np.zeros(4), np.zeros(4)))


def test_dice_known_values():
    seg = np.array([[0, 1, 1], [2, 2, 0]])
    assert ev.dice_score(seg, seg, 1) == ev.dice_score(seg, seg, 2) == 1.0
    assert ev.dice_score(np.array([1, 1, 0, 0]), np.array([0, 0, 1, 1]), 1) == 0.0
    assert ev.dice_score(np.array([1, 1, 0, 0]), np.array([1, 0, 1, 0]), 1) == 0.5
    b = np.array([1, 1, 0, 0])
    assert ev.mean_multilabel_dice(b, b) == 1.0
    # the reference's formulation includes background
    rng = np.random.default_rng(0)
    gt, pred = rng.integers(0, 4, (8, 8, 8)), rng.integers(0, 4, (8, 8, 8))
    assert ev.mean_multilabel_dice_ref(pred, gt) != ev.mean_multilabel_dice(pred, gt)


# --- PSNR / SSIM --------------------------------------------------------------


@pytest.mark.parametrize("win", [3, 7, 9])
@pytest.mark.parametrize("shape", [(11, 10, 12), (24, 20, 16)])
def test_ssim3d_psnr_match_jax(shape, win):
    rng = np.random.default_rng(win + shape[0])
    a = rng.random(shape)
    b = np.clip(a + 0.15 * rng.standard_normal(shape), 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(ev.ssim3d(ta, tb, win=win), jev.ssim3d(a, b, win=win),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ev.ssim3d(ta, tb, data_range=2.0, k1=0.02, k2=0.05, win=win),
                               jev.ssim3d(a, b, data_range=2.0, k1=0.02, k2=0.05, win=win),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ev.psnr(ta, tb), jev.psnr(a, b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ev.psnr(ta, tb, data_range=2.0), jev.psnr(a, b, data_range=2.0),
                               rtol=0, atol=1e-12)
    # float32 inputs and numpy arrays are computed in float64 alike
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_allclose(ev.ssim3d(torch.from_numpy(a32), b32, win=win),
                               jev.ssim3d(a32, b32, win=win), rtol=0, atol=1e-12)


def test_ssim_matches_brute_force_oracle():
    """skimage.metrics.structural_similarity's default math, literally:
    per full-window position, sample-covariance (ddof=1) moments, the SSIM
    formula, mean over the interior map."""
    rng = np.random.default_rng(4)
    a = rng.random((11, 10, 12))
    b = np.clip(a + 0.15 * rng.standard_normal(a.shape), 0, 1)
    win, dr = 7, 1.0
    c1, c2 = (0.01 * dr) ** 2, (0.03 * dr) ** 2
    pad = (win - 1) // 2
    vals = []
    for i in range(pad, a.shape[0] - pad):
        for j in range(pad, a.shape[1] - pad):
            for k in range(pad, a.shape[2] - pad):
                wa = a[i - pad:i + pad + 1, j - pad:j + pad + 1, k - pad:k + pad + 1].ravel()
                wb = b[i - pad:i + pad + 1, j - pad:j + pad + 1, k - pad:k + pad + 1].ravel()
                ua, ub = wa.mean(), wb.mean()
                vab = ((wa - ua) * (wb - ub)).sum() / (wa.size - 1)
                vals.append(((2 * ua * ub + c1) * (2 * vab + c2))
                            / ((ua**2 + ub**2 + c1) * (wa.var(ddof=1) + wb.var(ddof=1) + c2)))
    np.testing.assert_allclose(ev.ssim3d(torch.from_numpy(a), torch.from_numpy(b)),
                               np.mean(vals), rtol=1e-10)


def test_psnr_ssim_invariants():
    z, p1 = torch.zeros((8, 8, 8)), torch.full((8, 8, 8), 0.1)
    np.testing.assert_allclose(ev.psnr(z, p1), 20.0, rtol=1e-6)  # MSE 0.01
    r = torch.from_numpy(np.random.default_rng(0).random((4, 4, 4)))
    assert ev.psnr(r, r) == float("inf")
    a = torch.from_numpy(np.random.default_rng(1).random((16, 16, 16)))
    np.testing.assert_allclose(ev.ssim3d(a, a), 1.0, atol=1e-6)
    rng = np.random.default_rng(2)
    x = rng.random((16, 16, 16))
    s_small = ev.ssim3d(x, np.clip(x + 0.01 * rng.standard_normal(x.shape), 0, 1))
    s_big = ev.ssim3d(x, np.clip(x + 0.3 * rng.standard_normal(x.shape), 0, 1))
    assert 1.0 > s_small > s_big > 0.0
    u, v = rng.random((12, 12, 12)), rng.random((12, 12, 12))
    np.testing.assert_allclose(ev.ssim3d(u, v), ev.ssim3d(v, u), atol=1e-9)


@pytest.mark.parametrize("win", [1, 2, 4, 0, -3])
def test_ssim_rejects_bad_window_as_jax(win):
    a = np.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="odd") as ours:
        ev.ssim3d(torch.from_numpy(a), torch.from_numpy(a), win=win)
    with pytest.raises(ValueError) as ref:
        jev.ssim3d(a, a, win=win)
    assert str(ours.value) == str(ref.value)


def test_ssim_rejects_too_small_volume_as_jax():
    a = np.zeros((6, 8, 8))
    with pytest.raises(ValueError, match="win=7") as ours:
        ev.ssim3d(torch.from_numpy(a), torch.from_numpy(a))
    with pytest.raises(ValueError) as ref:
        jev.ssim3d(a, a)
    assert str(ours.value) == str(ref.value)


# --- evaluate_cases / calculate_dice_scores -----------------------------------


def _pairs(root, n=3, shape=(12, 11, 10)):
    rng = np.random.default_rng(5)
    for i in range(n):
        d = os.path.join(root, f"case{i}")
        os.makedirs(d)
        t = rng.random(shape).astype(np.float32)
        s = np.clip(t + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
        nifti.save(nifti.Nifti1Image(s, np.eye(4)), os.path.join(d, "sample.nii.gz"))
        nifti.save(nifti.Nifti1Image(t, np.eye(4)), os.path.join(d, "target.nii.gz"))
    os.makedirs(os.path.join(root, "no_pair"))  # skipped


def test_evaluate_cases_matches_jax(tmp_path):
    _pairs(str(tmp_path))
    ours = ev.evaluate_cases(str(tmp_path), device="cpu")
    assert ours["n"] == 3
    _close(ours, jev.evaluate_cases(str(tmp_path)))


def _labels(root, names, seed, shape=(10, 9, 8)):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for n in names:
        nifti.save(nifti.Nifti1Image(rng.integers(0, 4, shape).astype(np.int16), np.eye(4)),
                   os.path.join(root, n))


def test_calculate_dice_scores_matches_jax(tmp_path):
    _labels(str(tmp_path / "pred"), ["a.nii.gz", "b.nii.gz", "only_pred.nii.gz"], 0)
    _labels(str(tmp_path / "gt"), ["a.nii.gz", "b.nii.gz"], 1)
    # a case with no lesion in either volume: nan labels are skipped
    empty = np.zeros((10, 9, 8), np.int16)
    for d in ("pred", "gt"):
        nifti.save(nifti.Nifti1Image(empty, np.eye(4)), str(tmp_path / d / "c.nii.gz"))
    ours = ev.calculate_dice_scores(str(tmp_path / "pred"), str(tmp_path / "gt"))
    assert ours["n"] == 3
    _close(ours, jev.calculate_dice_scores(str(tmp_path / "pred"), str(tmp_path / "gt")))


def test_evaluate_synthesis_main_direct_on_cpu(tmp_path):
    _pairs(str(tmp_path / "s"))
    report = str(tmp_path / "r.json")
    got = ev.main(["--mode=direct", f"--sample_dir={tmp_path / 's'}", f"--report={report}",
                   "--device=cpu"])
    with open(report) as f:
        assert json.load(f) == got
    _close(got, jev.evaluate_cases(str(tmp_path / "s")))


def test_evaluate_synthesis_nnunet_mode_gates_on_the_predictor(tmp_path, monkeypatch):
    # no nnUNetv2_predict on PATH; the nnUNet_* variables the CLI exports
    # stay inside this test
    monkeypatch.setattr(os, "environ", {**os.environ, "PATH": str(tmp_path)})
    got = ev.main(["--mode=nnunet", f"--completed_dir={tmp_path}", f"--gt_dir={tmp_path}",
                   f"--work_dir={tmp_path / 'w'}", f"--report={tmp_path / 'r.json'}",
                   "--device=cpu"])
    assert got == {"error": "nnUNetv2 unavailable"}
    assert os.path.isdir(tmp_path / "w" / "nnUNet_results")
    with pytest.raises(SystemExit):
        ev.main(["--mode=nnunet", f"--completed_dir={tmp_path}", f"--work_dir={tmp_path / 'w'}",
                 "--device=cpu"])


# --- drop_modality / prepare_nnunet_dataset -----------------------------------


def _brats_tree(root, n=6, shape=(10, 9, 8)):
    rng = np.random.default_rng(7)
    for i in range(n):
        case = f"BraTS-GLI-{i:05d}-000"
        d = os.path.join(root, case)
        os.makedirs(d)
        for m in MODALITIES:
            nifti.save(nifti.Nifti1Image((rng.random(shape) * 900).astype(np.float32),
                                         np.diag([1.0, 1.1, 1.2, 1.0])),
                       os.path.join(d, f"{case}-{m}.nii.gz"))
        nifti.save(nifti.Nifti1Image(rng.choice([0, 1, 2, 4], shape).astype(np.int16), np.eye(4)),
                   os.path.join(d, f"{case}-seg.nii.gz"))
    with open(os.path.join(root, "README.txt"), "w") as f:  # a stray file: consumes a draw
        f.write("x")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_drop_modality_matches_jax_file_for_file(tmp_path):
    src = str(tmp_path / "src")
    _brats_tree(src)
    drop_modality.main([f"--input_dir={src}", f"--output_dir={tmp_path / 'ours'}"])
    jdrop.main([f"--input_dir={src}", f"--output_dir={tmp_path / 'ref'}"])
    ours, ref = _files(str(tmp_path / "ours")), _files(str(tmp_path / "ref"))
    assert ours == ref and len(ours) == 6 * 5  # 3 modalities + seg + marker
    for f in ours:
        assert filecmp.cmp(tmp_path / "ours" / f, tmp_path / "ref" / f, shallow=False), f
    # the reference's draw: one randint over all 7 sorted entries
    draws = np.random.RandomState(123456).randint(0, 4, size=7)
    for i in range(6):
        marker = [f for f in ours if f.startswith(f"BraTS-GLI-{i:05d}") and "missing_" in f]
        assert marker == [f"BraTS-GLI-{i:05d}-000/missing_{drop_modality._DROP_ORDER[draws[i]]}.txt"]


def test_prepare_nnunet_dataset_matches_jax_file_for_file(tmp_path):
    src = str(tmp_path / "src")
    _brats_tree(src)
    # an incomplete case is skipped; a labels_dir seg wins over the case's
    os.remove(os.path.join(src, "BraTS-GLI-00002-000", "BraTS-GLI-00002-000-t2w.nii.gz"))
    _labels(str(tmp_path / "labels"), ["BraTS-GLI-00004-000-seg.nii.gz"], 3)
    argv = [f"--input_dir={src}", f"--labels_dir={tmp_path / 'labels'}", "--dataset_id=7"]
    prepare_nnunet_dataset.main(argv + [f"--nnunet_raw={tmp_path / 'ours'}"])
    jprep.main(argv + [f"--nnunet_raw={tmp_path / 'ref'}"])
    ours, ref = _files(str(tmp_path / "ours")), _files(str(tmp_path / "ref"))
    assert ours == ref and len(ours) == 5 * 4 + 5 + 1
    for f in ours:
        a, b = tmp_path / "ours" / f, tmp_path / "ref" / f
        if "/labelsTr/" not in f:
            assert filecmp.cmp(a, b, shallow=False), f  # copies and dataset.json
            continue
        # written labels: voxel for voxel, the same dtype, affine and zooms
        # (each package names itself in the header's descrip field)
        x, y = nifti.load(str(a)), jnifti.load(str(b))
        assert x.dataobj.dtype == y.dataobj.dtype == np.int16
        np.testing.assert_array_equal(x.dataobj, y.dataobj)
        np.testing.assert_array_equal(x.affine, y.affine)
        assert x.header.get_zooms() == y.header.get_zooms()
    with open(tmp_path / "ours" / "Dataset007_BraTS2023" / "dataset.json") as f:
        assert json.load(f)["numTraining"] == 5
    seg = np.asarray(jnifti.load(os.path.join(src, "BraTS-GLI-00000-000",
                                              "BraTS-GLI-00000-000-seg.nii.gz")).dataobj)
    got = nifti.load(str(tmp_path / "ours" / "Dataset007_BraTS2023" / "labelsTr"
                         / "BraTS-GLI-00000-000.nii.gz")).dataobj
    np.testing.assert_array_equal(got, jprep.remap_labels(seg))
    np.testing.assert_array_equal(prepare_nnunet_dataset.remap_labels(seg), jprep.remap_labels(seg))


def test_evaluation_clis_refuse_to_fall_back_to_cpu(tmp_path):
    """Without a GPU, a CLI that computes on the card raises unless
    ``--device cpu``; nothing continues on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    _pairs(str(tmp_path / "s"), n=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        ev.main(["--mode=direct", f"--sample_dir={tmp_path / 's'}",
                 f"--report={tmp_path / 'r.json'}"])
    with pytest.raises(RuntimeError, match="no GPU"):
        ev.evaluate_cases(str(tmp_path / "s"))
    assert not (tmp_path / "r.json").exists()
