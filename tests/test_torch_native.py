"""The port's native NIfTI decoder (``fast_cwdm_tpu_torch/data/native``):
tests/test_native.py's cases against the port's copy, the two copies
against each other bit for bit on the same files, and the port's
``load_preprocessed`` against the JAX package's under each of its three
settings (decoder, ``FAST_CWDM_NATIVE=0``, decoder unavailable)."""

import numpy as np
import pytest

from fast_cwdm_tpu.data import brats as jbrats
from fast_cwdm_tpu.data import native as jnative
from fast_cwdm_tpu_torch.data import brats, native, nifti
from fast_cwdm_tpu_torch.data.loader import ThreadedLoader


@pytest.fixture(autouse=True)
def decoders():
    if not native.available():
        pytest.skip("the port's native decoder does not build here (no g++)")
    if not jnative.available():
        pytest.skip("the JAX package's native decoder does not build here")


@pytest.fixture(scope="module")
def volume_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("nifti")
    rng = np.random.default_rng(0)
    vol = (rng.random((24, 24, 15)) * 1000).astype(np.float32)
    aff = np.array(
        [[-1, 0, 0, 12], [0, 1, 0, -12], [0, 0, 1.2, -7], [0, 0, 0, 1.0]]
    )
    p = str(d / "BraTS-GLI-00000-000-t1n.nii.gz")
    nifti.save(nifti.Nifti1Image(vol, aff), p)
    return p, vol, aff


def _patched(path, slope, inter):
    """Overwrite scl_slope/scl_inter (header offsets 112/116) of a .nii."""
    with open(path, "r+b") as f:
        f.seek(112)
        f.write(np.array([slope, inter], dtype="<f4").tobytes())


@pytest.fixture(scope="module")
def files(tmp_path_factory, volume_file):
    """Decodable files of every kind the tests read: gzip float32, int16,
    uint8, float64, a NaN slope, a NaN intercept, a scaled int16."""
    d = tmp_path_factory.mktemp("kinds")
    rng = np.random.default_rng(1)
    out = {"float32_gz": volume_file[0]}
    arrays = {
        "int16": np.arange(-100, 116, dtype=np.int16).reshape(6, 6, 6),
        "uint8": rng.integers(0, 255, (7, 5, 6), dtype=np.uint8),
        "float64": rng.standard_normal((6, 7, 5)) * 40.0,
        "nan_slope": np.arange(216, dtype=np.float32).reshape(6, 6, 6),
        "nan_inter": np.arange(216, dtype=np.float32).reshape(6, 6, 6),
        "scaled_int16": rng.integers(-500, 500, (8, 6, 5), dtype=np.int16),
    }
    for name, data in arrays.items():
        p = str(d / f"{name}.nii")
        nifti.save(nifti.Nifti1Image(data, np.eye(4)), p)
        out[name] = p
    _patched(out["nan_slope"], np.nan, np.nan)
    _patched(out["nan_inter"], 2.0, np.nan)
    _patched(out["scaled_int16"], 0.37, -12.5)
    return out


def test_decode_exact(volume_file):
    p, vol, aff = volume_file
    before = native.load_volume.decodes
    nvol, naff = native.load_volume(p)
    np.testing.assert_array_equal(nvol, vol)
    np.testing.assert_allclose(naff, aff, atol=1e-5)
    assert native.load_volume.decodes == before + 1


def test_clip_normalize_matches_numpy(volume_file):
    _, vol, _ = volume_file
    ref = brats.clip_and_normalize(vol.astype(np.float64))
    out = vol.copy(order="F")
    assert native.clip_and_normalize_inplace(out) is not None
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_int16_decode(files):
    nvol, _ = native.load_volume(files["int16"])
    np.testing.assert_array_equal(nvol, np.arange(-100, 116, dtype=np.float32).reshape(6, 6, 6))


def test_nan_scl_slope_means_no_scaling(files):
    """NIfTI-1: a NaN scl_slope (written by many tools instead of 0) means
    no scaling, on both the native and the numpy reader."""
    data = np.arange(216, dtype=np.float32).reshape(6, 6, 6)
    nvol, _ = native.load_volume(files["nan_slope"])
    np.testing.assert_array_equal(nvol, data)
    np.testing.assert_array_equal(nifti.load(files["nan_slope"]).get_fdata().astype(np.float32),
                                  data)


def test_nan_scl_inter_ignored(files):
    """A valid slope with a NaN intercept scales without the offset, both
    paths."""
    data = np.arange(216, dtype=np.float32).reshape(6, 6, 6) * 2.0
    nvol, _ = native.load_volume(files["nan_inter"])
    np.testing.assert_array_equal(nvol, data)
    np.testing.assert_array_equal(nifti.load(files["nan_inter"]).get_fdata().astype(np.float32),
                                  data)


def test_load_preprocessed_native_vs_python(volume_file, monkeypatch):
    p, _, _ = volume_file
    nat = brats.load_preprocessed(p)
    monkeypatch.setenv("FAST_CWDM_NATIVE", "0")
    py = brats.load_preprocessed(p)
    assert nat.shape == py.shape
    np.testing.assert_allclose(nat, py, atol=1e-5)


@pytest.mark.parametrize("kind", ["float32_gz", "int16", "uint8", "float64", "nan_slope",
                                  "nan_inter", "scaled_int16"])
def test_decoder_equals_the_jax_packages_bit_for_bit(files, kind):
    """The same file through both packages' decoders: the same voxels, the
    same affine, the same clip/normalize, bit for bit."""
    ours, theirs = native.load_volume(files[kind]), jnative.load_volume(files[kind])
    assert ours[0].dtype == theirs[0].dtype == np.float32
    assert ours[0].shape == theirs[0].shape and ours[0].tobytes() == theirs[0].tobytes()
    assert np.array_equal(ours[1], theirs[1])
    a = native.clip_and_normalize_inplace(ours[0])
    b = jnative.clip_and_normalize_inplace(theirs[0])
    assert a.tobytes() == b.tobytes()


@pytest.fixture
def no_native(monkeypatch):
    """The port's decoder as where it cannot build."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()


@pytest.mark.parametrize("kind", ["float32_gz", "int16", "uint8", "float64", "nan_slope",
                                  "scaled_int16"])
@pytest.mark.parametrize("setting", ["default", "FAST_CWDM_NATIVE=0", "decoder unavailable"])
def test_load_preprocessed_equals_the_jax_packages(files, kind, setting, monkeypatch, request):
    """The port's ``load_preprocessed`` against the JAX package's, bit for
    bit: by default both decode natively (float32); under
    ``FAST_CWDM_NATIVE=0`` both read in float64; where the port's decoder
    cannot build, its numpy reproduction of the decoder's float32
    arithmetic equals the JAX package's default (its decoder)."""
    if setting == "FAST_CWDM_NATIVE=0":
        monkeypatch.setenv("FAST_CWDM_NATIVE", "0")
    if setting == "decoder unavailable":
        request.getfixturevalue("no_native")
    before = native.load_volume.decodes
    ours, theirs = brats.load_preprocessed(files[kind]), jbrats.load_preprocessed(files[kind])
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    assert ours.tobytes() == theirs.tobytes()
    assert native.load_volume.decodes == before + (setting == "default")


def test_a_failed_build_leaves_the_decoder_unavailable(tmp_path, files, monkeypatch):
    """Where the library does not link (here: a missing library in place of
    zlib), ``available()`` is False, no file is left in the build
    directory, and ``load_preprocessed`` takes the float32 numpy path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LINK_FLAGS", ("-lno_such_library_fastnifti",))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available() and native.load_volume(files["int16"]) is None
    assert not any((tmp_path / "build").iterdir())
    before = native.load_volume.decodes
    got = brats.load_preprocessed(files["float32_gz"])
    assert got.tobytes() == jbrats.load_preprocessed(files["float32_gz"]).tobytes()
    assert native.load_volume.decodes == before


def test_unreadable_files_fall_back(tmp_path, files):
    """A truncated gzip and a datatype the decoder lacks return None (the
    caller takes the numpy reader), as in the JAX package."""
    raw = open(files["float32_gz"], "rb").read()
    bad = tmp_path / "truncated.nii.gz"
    bad.write_bytes(raw[: len(raw) // 2])
    assert native.load_volume(str(bad)) is None
    odd = str(tmp_path / "complex.nii")
    nifti.save(nifti.Nifti1Image(np.ones((4, 4, 4), np.int64), np.eye(4)), odd)
    assert native.load_volume(odd) is None and jnative.load_volume(odd) is None
    np.testing.assert_array_equal(brats.load_preprocessed(odd), jbrats.load_preprocessed(odd))


def test_threaded_loader_decodes_natively(tmp_path):
    """BRATSVolumes under ThreadedLoader (4 threads): every volume through
    the decoder, the items equal to one thread's."""
    rng = np.random.default_rng(2)
    for c in range(3):
        d = tmp_path / "tree" / f"0000{c}"
        d.mkdir(parents=True)
        for m in brats.MODALITIES:
            nifti.save(nifti.Nifti1Image((rng.random((20, 20, 12)) * 9).astype(np.float32),
                                         np.eye(4)), str(d / f"BraTS-GLI-0000{c}-000-{m}.nii.gz"))
    ds = brats.BRATSVolumes(str(tmp_path / "tree"))
    before = native.load_volume.decodes
    items = list(ThreadedLoader(ds, num_workers=4))
    assert native.load_volume.decodes == before + 12
    for i, item in enumerate(items):
        for m in brats.MODALITIES:
            assert item[m].tobytes() == ds[i][m].tobytes()
