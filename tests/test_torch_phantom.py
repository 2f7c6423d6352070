"""The port's phantom generator (``fast_cwdm_tpu_torch/data/phantom.py``)
against the JAX package's: the same arrays bit for bit for the same seed
(with and without the rim texture), the same segmenter labels, phantom
trees that read back equal; then the JAX package's phantom invariants
(tests/test_phantom.py, tests/test_phantom_segmenter.py) on the port's
copy."""

import functools
import os

import numpy as np
import pytest
import torch

from fast_cwdm_tpu.data import nifti as jnifti
from fast_cwdm_tpu.data import phantom as jphantom
from fast_cwdm_tpu_torch.cli.evaluate_synthesis import dice_score, mean_multilabel_dice
from fast_cwdm_tpu_torch.data import nifti, phantom
from fast_cwdm_tpu_torch.data.phantom import (
    MODALITIES,
    T1C_COMBO,
    generate_case,
    segment_case,
    write_case,
    write_phantom_dataset,
)

torch.set_num_threads(2)

QUICK = (40, 40, 26)  # quality_bench --quick
SMALL = (60, 60, 40)  # tests/test_phantom.py
SHAPE = (120, 120, 78)  # tests/test_phantom_segmenter.py


@functools.lru_cache(maxsize=None)
def _case10000():
    """Case 10000 at SHAPE, shared by the segmenter tests (read only)."""
    return generate_case(10000, shape=SHAPE)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_constants_match_jax():
    assert phantom.MODALITIES == jphantom.MODALITIES
    assert phantom.RAW_SHAPE == jphantom.RAW_SHAPE
    assert phantom.CONTRAST == jphantom.CONTRAST
    assert phantom.T1C_COMBO == jphantom.T1C_COMBO
    assert phantom.LESION_PROB == jphantom.LESION_PROB


@pytest.mark.parametrize("rim", [0.0, 0.08])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_case_matches_jax_bit_for_bit(seed, rim):
    _same(generate_case(seed, QUICK, rim_texture=rim),
          jphantom.generate_case(seed, QUICK, rim_texture=rim))


@pytest.mark.parametrize("seed,shape", [(9, SMALL), (10, SMALL), (10000, SHAPE)])
def test_segment_case_matches_jax(seed, shape):
    vols = _case10000() if shape == SHAPE else jphantom.generate_case(seed, shape)
    ours = segment_case(vols)
    assert ours.dtype == np.int16 and ours.any()
    np.testing.assert_array_equal(ours, jphantom.segment_case(vols))
    # and at another erosion, on a rescaled target
    scaled = dict(vols, t1c=vols["t1c"] / float(vols["t1c"].max()))
    np.testing.assert_array_equal(segment_case(scaled, erode=2),
                                  jphantom.segment_case(scaled, erode=2))


def _read_tree(root, load):
    out = {}
    for case in sorted(os.listdir(root)):
        for f in sorted(os.listdir(os.path.join(root, case))):
            img = load(os.path.join(root, case, f))
            out[f"{case}/{f}"] = (np.asarray(img.dataobj), np.asarray(img.affine))
    return out


def test_write_phantom_dataset_reads_back_equal(tmp_path):
    ours = write_phantom_dataset(str(tmp_path / "ours"), 3, start_seed=5, shape=QUICK,
                                 workers=2, rim_texture=0.05)
    ref = jphantom.write_phantom_dataset(str(tmp_path / "ref"), 3, start_seed=5, shape=QUICK,
                                         workers=2, rim_texture=0.05)
    assert [os.path.basename(d) for d in ours] == [os.path.basename(d) for d in ref]
    a = _read_tree(str(tmp_path / "ours"), nifti.load)
    b = _read_tree(str(tmp_path / "ref"), jnifti.load)
    assert a.keys() == b.keys() and len(a) == 3 * 5
    for k in a:
        assert a[k][0].dtype == b[k][0].dtype, k
        np.testing.assert_array_equal(a[k][0], b[k][0])
        np.testing.assert_array_equal(a[k][1], b[k][1])
    # each file is the generator's array, read back bit for bit
    vols = generate_case(6, QUICK, rim_texture=0.05)
    for m in MODALITIES + ("seg",):
        np.testing.assert_array_equal(a[f"00006/BraTS-GLI-00006-000-{m}.nii.gz"][0], vols[m])


def test_write_case_missing_modality_matches_jax(tmp_path):
    """An incomplete case (for completion pipelines) omits the target."""
    ours, ref = str(tmp_path / "ours" / "00042"), str(tmp_path / "ref" / "00042")
    write_case(ours, 42, shape=QUICK, modalities=("t1n", "t2w", "t2f"), with_seg=False)
    jphantom.write_case(ref, 42, shape=QUICK, modalities=("t1n", "t2w", "t2f"), with_seg=False)
    files = sorted(os.listdir(ours))
    assert files == sorted(os.listdir(ref))
    assert len(files) == 3 and not any("t1c" in f for f in files)
    for f in files:
        np.testing.assert_array_equal(nifti.load(os.path.join(ours, f)).dataobj,
                                      jnifti.load(os.path.join(ref, f)).dataobj)


# --- the JAX package's phantom invariants, on the port's copy -------------


def _determinism_and_invariants():
    a = generate_case(7, shape=SMALL)
    b = generate_case(7, shape=SMALL)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{k} not deterministic"
    c = generate_case(8, shape=SMALL)
    assert not np.array_equal(a["t1n"], c["t1n"])
    for m in MODALITIES:
        v = a[m]
        assert v.shape == SMALL and v.dtype == np.float32
        assert float(v.min()) >= 0.0
        assert float(v.max()) > 100.0, "raw scanner-like intensity range"
    assert set(np.unique(a["seg"])) <= {0, 1, 2, 4}
    # background is EXACTLY zero in every modality at the same voxels
    bg = a["t1n"] == 0
    assert bg.any() and not bg.all()
    for m in MODALITIES:
        assert (a[m][bg] == 0).all()


def _lesion_frequency_and_labels():
    with_lesion = 0
    for seed in range(12):
        seg = generate_case(seed, shape=SMALL)["seg"]
        if (seg > 0).any():
            with_lesion += 1
            assert {1, 2, 4} <= set(np.unique(seg)), (
                "a lesion case must carry all three BraTS raw labels")
    assert with_lesion >= 6, f"only {with_lesion}/12 cases grew a lesion"
    none = generate_case(0, shape=SMALL, lesion_prob=0.0)
    assert not (none["seg"] > 0).any()


def _t1c_well_posedness():
    """t1c is recoverable from (t1n, t2w, t2f, core): the benchmark's
    premise."""
    case = generate_case(11, shape=SMALL)
    brain = case["t1n"] > 0
    core = (case["seg"] == 4).astype(np.float32)
    X = np.stack([case["t1n"][brain], case["t2w"][brain], case["t2f"][brain], core[brain],
                  np.ones(int(brain.sum()), np.float32)], axis=1).astype(np.float64)
    y = case["t1c"][brain].astype(np.float64)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ coef
    r2 = 1.0 - float((resid**2).sum()) / float(((y - y.mean()) ** 2).sum())
    assert r2 > 0.99, f"t1c not determined by inputs (R^2={r2:.4f})"
    assert len(T1C_COMBO) == 5


def _rim_texture_only_perturbs_t1c():
    base = generate_case(9, shape=SMALL)
    zero = generate_case(9, shape=SMALL, rim_texture=0.0)
    for k in base:
        assert np.array_equal(base[k], zero[k]), f"{k} shifted at rim=0"
    rim = generate_case(9, shape=SMALL, rim_texture=0.08)
    assert base["seg"].any(), "seed 9 must carry a lesion for this test"
    for m in ("t1n", "t2w", "t2f"):
        assert np.array_equal(base[m], rim[m]), f"{m} must not change"
    np.testing.assert_array_equal(base["seg"], rim["seg"])
    diff = np.abs(rim["t1c"].astype(np.float64) - base["t1c"])
    assert diff.max() > 0
    changed = diff > 1e-6 * max(1.0, base["t1c"].max())
    lesion_bbox = np.zeros_like(changed)
    ii = np.nonzero(base["seg"] > 0)
    pad = 12
    lo = [max(0, int(x.min()) - pad) for x in ii]
    hi = [min(s, int(x.max()) + pad) for x, s in zip(ii, SMALL)]
    lesion_bbox[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
    assert changed[~lesion_bbox].sum() == 0


def _rim_texture_case_seeded():
    r7, b7 = generate_case(10, shape=SMALL, rim_texture=0.08), generate_case(10, shape=SMALL)
    r9, b9 = generate_case(9, shape=SMALL, rim_texture=0.08), generate_case(9, shape=SMALL)
    assert b7["seg"].any() and b9["seg"].any()
    d7, d9 = r7["t1c"] - b7["t1c"], r9["t1c"] - b9["t1c"]
    m = (np.abs(d7) > 0) | (np.abs(d9) > 0)
    assert m.sum() > 100
    c = np.corrcoef(d7[m], d9[m])[0, 1]
    assert abs(c) < 0.5, f"rim textures too correlated: {c}"


def _loader_roundtrip(tmp_path):
    from fast_cwdm_tpu_torch.data.brats import BRATSVolumes

    root = str(tmp_path / "phantom")
    dirs = write_phantom_dataset(root, 2, start_seed=3, shape=SMALL)
    assert len(dirs) == 2 and all(os.path.isdir(d) for d in dirs)
    ds = BRATSVolumes(root, mode="train")
    assert len(ds) == 2
    item = ds[0]
    for m in MODALITIES:
        v = np.asarray(item[m])
        # loader contract: pad Z→160, crop X,Y by 8, channel-last
        assert v.shape == (SMALL[0] - 16, SMALL[1] - 16, 160, 1)
        assert 0.0 <= float(v.min()) and float(v.max()) <= 1.0


def _segment_recovers_labels():
    case = _case10000()
    pred = segment_case(case)
    assert dice_score(pred, case["seg"], 4) > 0.9, "enhancing core is exactly invertible"
    assert mean_multilabel_dice(pred, case["seg"]) > 0.6


def _segment_scale_invariant():
    case = _case10000()
    rescaled = dict(case, t1c=case["t1c"] / float(case["t1c"].max()), t2w=case["t2w"] * 3.7)
    agree = float((segment_case(case) == segment_case(rescaled)).mean())
    assert agree > 0.999, agree


def _segment_no_lesion_is_all_background():
    v = generate_case(3, shape=SHAPE)  # seed 3 draws no lesion
    assert not v["seg"].any()
    assert not segment_case(v).any()


def _segment_erased_core_predicts_nothing():
    case = _case10000()
    a1, a2, a3, b0, _ = T1C_COMBO
    g = {m: np.median(case[m][case[m] > 0]) for m in ("t1n", "t2w", "t2f")}
    n = {m: case[m] / g[m] * 0.5 for m in ("t1n", "t2w", "t2f")}
    flat = dict(case, t1c=np.where(case["t1c"] > 0, a1 * n["t1n"] + a2 * n["t2w"] + a3 * n["t2f"]
                                   + b0, 0.0).astype(np.float32))
    assert not (segment_case(flat) == 4).any()


INVARIANTS = {
    "determinism_and_invariants": _determinism_and_invariants,
    "lesion_frequency_and_labels": _lesion_frequency_and_labels,
    "t1c_well_posedness": _t1c_well_posedness,
    "rim_texture_only_perturbs_t1c": _rim_texture_only_perturbs_t1c,
    "rim_texture_case_seeded": _rim_texture_case_seeded,
    "loader_roundtrip": _loader_roundtrip,
    "segment_recovers_labels": _segment_recovers_labels,
    "segment_scale_invariant": _segment_scale_invariant,
    "segment_no_lesion_is_all_background": _segment_no_lesion_is_all_background,
    "segment_erased_core_predicts_nothing": _segment_erased_core_predicts_nothing,
}


@pytest.mark.parametrize("name", list(INVARIANTS))
def test_jax_phantom_invariants_hold_on_the_port(name, tmp_path):
    fn = INVARIANTS[name]
    fn(tmp_path) if fn.__code__.co_argcount else fn()


# --- scripts/segmenter_calibration.py ---------------------------------------


def _jax_segcal():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "segmenter_calibration.py")
    spec = importlib.util.spec_from_file_location("jax_segcal", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("alpha,shift", [(1.0, (0, 0, 0)), (0.4, (0, 0, 0)), (1.0, (2, 2, 0))])
def test_degraded_case_matches_jax(alpha, shift):
    from fast_cwdm_tpu_torch.scripts import segmenter_calibration as segcal

    _same(segcal.degraded_case(10, alpha=alpha, shift=shift, shape=SMALL),
          _jax_segcal().degraded_case(10, alpha=alpha, shift=shift, shape=SMALL))


def test_flattened_case_matches_jax():
    from fast_cwdm_tpu_torch.scripts import segmenter_calibration as segcal

    _same(segcal.flattened_case(10, shape=SMALL), _jax_segcal().flattened_case(10, shape=SMALL))


def test_calibration_alpha1_reproduces_and_alpha0_removes_et():
    """α = 1 reproduces the real case bit for bit; α = 0 strips the
    enhancement exactly where the GT core is and nowhere else."""
    from fast_cwdm_tpu_torch.scripts import segmenter_calibration as segcal

    real = generate_case(10, shape=SMALL)
    _same(segcal.degraded_case(10, alpha=1.0, shift=(0, 0, 0), shape=SMALL), real)
    deg = segcal.degraded_case(10, alpha=0.0, shift=(0, 0, 0), shape=SMALL)
    core = real["seg"] == 4
    assert core.any()
    assert deg["t1c"][core].mean() < real["t1c"][core].mean() * 0.85
    out = (real["seg"] == 0) & (real["t1c"] > 0)
    np.testing.assert_allclose(deg["t1c"][out], real["t1c"][out], rtol=1e-5)


def test_calibration_summary_matches_jax():
    from fast_cwdm_tpu_torch.scripts import segmenter_calibration as segcal

    rows = [{"seed": 1, "dice": 0.5, "per_label": {"edema": 0.2, "ncr": float("nan"), "et": 0.9}},
            {"seed": 2, "dice": float("nan"), "per_label": {"edema": 0.4, "ncr": 0.1, "et": 0.7}}]
    ours, ref = segcal.summarize(rows, alpha=0.5), _jax_segcal().summarize(rows, alpha=0.5)
    assert ours == ref and segcal.fmt(ours) == _jax_segcal().fmt(ref)


# --- preprocessing: the JAX package's two paths -------------------------------


@pytest.mark.parametrize("dtype,slope,inter", [
    (np.float32, 1.0, 0.0), (np.float32, 0.5, -3.0), (np.int16, 2.5, 3.0), (np.uint8, 0.0, 7.0),
    (np.float64, 1.0, 0.0), (np.int16, float("nan"), 1.0)])
def test_load_preprocessed_follows_both_jax_paths(tmp_path, monkeypatch, dtype, slope, inter):
    """The port preprocesses as the JAX package's C++ decoder does
    (float32), bit for bit; its float64 ``preprocess_volume`` equals the
    JAX package's numpy reader (``FAST_CWDM_NATIVE=0``) bit for bit. The
    two differ in the last bit."""
    from fast_cwdm_tpu.data import brats as jbrats
    from fast_cwdm_tpu.data import native
    from fast_cwdm_tpu_torch.data import brats

    if not native.available():
        pytest.skip("the JAX package's C++ decoder does not build here (no g++/zlib)")
    vols = generate_case(3, QUICK)
    raw = (vols["t2w"] / 4).astype(dtype)
    path = str(tmp_path / "BraTS-GLI-00003-000-t2w.nii.gz")
    nifti.save(nifti.Nifti1Image(raw, np.eye(4)), path)
    if slope != 1.0 or inter != 0.0:  # scale the voxels through the header
        hdr = nifti._build_header(raw, np.eye(4))
        hdr = hdr[:112] + np.array([slope, inter], "<f4").tobytes() + hdr[120:]
        path = path[:-3]  # an uncompressed .nii: header, 4 pad bytes, voxels
        with open(path, "wb") as f:
            f.write(hdr + b"\x00" * 4 + raw.tobytes(order="F"))
        assert np.isnan(slope) or nifti.load(path).header.scl_slope == np.float32(slope)
    vol, _ = native.load_volume(path)
    ref = jbrats.pad_crop(native.clip_and_normalize_inplace(vol))
    ours = brats.load_preprocessed(path)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()
    monkeypatch.setenv("FAST_CWDM_NATIVE", "0")
    f64 = brats.preprocess_volume(nifti.load(path).get_fdata())
    assert f64.tobytes() == jbrats.load_preprocessed(path).tobytes()
    assert np.abs(f64.astype(np.float64) - ours).max() <= 2.0**-23


# --- data/reduce.py: numpy 2.0's float32 summation order ---------------------


def _oracle_sum(a):
    """numpy 2.0's float32 add.reduce, literally: chunks of 8192 added in
    turn to 0; each chunk pairwise (halves, the left a multiple of 8) down
    to blocks of ≤ 128, each summed in 8 interleaved accumulators."""
    def pw(x):
        n = len(x)
        if n < 8:
            res = np.float32(0.0)
            for v in x:
                res = np.float32(res + v)
            return res
        if n <= 128:
            r = [x[j] for j in range(8)]
            i = 8
            while i < n - n % 8:
                r = [np.float32(r[j] + x[i + j]) for j in range(8)]
                i += 8
            res = np.float32(np.float32(np.float32(r[0] + r[1]) + np.float32(r[2] + r[3]))
                             + np.float32(np.float32(r[4] + r[5]) + np.float32(r[6] + r[7])))
            for v in x[i:]:
                res = np.float32(res + v)
            return res
        n2 = n // 2
        n2 -= n2 % 8
        return np.float32(pw(x[:n2]) + pw(x[n2:]))

    total = np.float32(0.0)
    for c in range(0, len(a), 8192):
        total = np.float32(total + pw(a[c:c + 8192]))
    return total


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 127, 128, 129, 1000, 8192, 8193, 20011])
def test_reduce_follows_numpy_2_0_order(n):
    from fast_cwdm_tpu_torch.data import reduce

    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 37 + 5).astype(np.float32)
    assert reduce.pairwise_sum(a) == _oracle_sum(list(a))
    if n:
        assert reduce.mean(a) == np.float32(np.float64(_oracle_sum(list(a))) / n)
        # this environment's numpy sums in that order too
        assert (reduce.pairwise_sum(a), reduce.mean(a), reduce.std(a)) == (a.sum(), a.mean(), a.std())
    if n >= 6:  # a 3-D array sums in the order of its flat view
        a3 = a[: (n // 6) * 6].reshape(2, 3, -1)
        assert reduce.mean(a3) == reduce.mean(a3.ravel()) == a3.mean()
