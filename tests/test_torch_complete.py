"""The port's dataset-completion path against the JAX package's on the
CPU: ``complete_dataset`` and ``sample_auto`` against JAX's CLIs on the
same tree and the same JAX-written ``.ckpt`` (the files, their geometry,
the pass-through, the failure accounting), ``--shard``, the un-crop and
header reads, and the ordered prefetch loader."""

import filecmp
import os
import threading
import time

import numpy as np
import pytest
import torch

from fast_cwdm_tpu.cli import complete_dataset as jcd
from fast_cwdm_tpu.cli import sample_auto as jsa
from fast_cwdm_tpu.data import brats as jbrats
from fast_cwdm_tpu.data import loader as jloader
from fast_cwdm_tpu.data import nifti as jnifti
from fast_cwdm_tpu.training import bridge
from fast_cwdm_tpu.training import checkpoints as jckpt
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.cli import complete_dataset as cd
from fast_cwdm_tpu_torch.cli import sample_auto as sa
from fast_cwdm_tpu_torch.data import brats, nifti
from fast_cwdm_tpu_torch.data.loader import ThreadedLoader
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

MODALITIES = ("t1n", "t1c", "t2w", "t2f")
TINY = dict(
    num_channels=16, num_res_blocks=1, channel_mult="1,2", attention_resolutions="",
    num_groups=8, bottleneck_attention=False, image_size=8, resample_2d=False,
    in_channels=32, out_channels=8, dims=3, diffusion_steps=4, sample_schedule="sampled",
    dtype="float32",
)
# the flags sample_auto takes for the same model (test_cli.py's TINY_FLAGS)
AUTO_FLAGS = [f"--{k}={v}" for k, v in TINY.items() if k != "dtype"] + ["--mode=i2i"]


def _make_case(case_dir, modalities=MODALITIES, shape=(24, 24, 15), seed=0):
    """test_cli.py's synthetic case: four modalities and a segmentation."""
    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = os.path.basename(case_dir)
    for m in modalities:
        vol = (rng.random(shape) * 900 + 100).astype(np.float32)
        nifti.save(nifti.Nifti1Image(vol, np.diag([1.0, 1.2, 1.5, 1.0])),
                   os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))
    seg = rng.integers(0, 3, shape).astype(np.int16)
    nifti.save(nifti.Nifti1Image(seg, np.eye(4)), os.path.join(case_dir, f"BraTS-GLI-{base}-000-seg.nii.gz"))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A BEST .ckpt for t1c written by the JAX package, with its sidecar."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = common.production_config(**TINY)
    model, _ = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    from fast_cwdm_tpu.cli import common as jcommon

    jmodel, _ = jcommon.build_model_and_diffusion(cfg)
    params = bridge.torch_to_flax(sd, jmodel)
    jckpt.save_checkpoint(str(d / jckpt.best_checkpoint_name("t1c", "sampled", 4)),
                          {"params": params, "ema_params": (params,), "step": 2},
                          config={**cfg, "contr": "t1c"})
    return str(d)


def _tree(root, n_incomplete=2, corrupt=False):
    for i in range(n_incomplete):
        _make_case(os.path.join(root, f"{i:05d}"), modalities=("t1n", "t2w", "t2f"), seed=i)
    _make_case(os.path.join(root, "00100"), seed=9)  # complete: passed through
    if corrupt:  # an unreadable case: counted once as failed
        bad = os.path.join(root, "00200")
        _make_case(bad, modalities=("t1n", "t2w", "t2f"), seed=5)
        with open(os.path.join(bad, "BraTS-GLI-00200-000-t2w.nii.gz"), "wb") as f:
            f.write(b"not a nifti")
    return root


def _check_passthrough(inp, out, case):
    """Every input file byte-identical in the output."""
    for f in os.listdir(os.path.join(inp, case)):
        assert filecmp.cmp(os.path.join(inp, case, f), os.path.join(out, case, f), shallow=False)


def _check_completed(inp, out, case, missing="t1c"):
    """The present files passed through; the synthesized one at the source
    geometry, finite, in [0,1], zero in the 8-voxel X/Y border. Returns
    the synthesized image."""
    _check_passthrough(inp, out, case)
    src = nifti.load(os.path.join(inp, case, f"BraTS-GLI-{case}-000-t1n.nii.gz"))
    img = nifti.load(os.path.join(out, case, f"{case}-{missing}.nii.gz"))
    vol = img.get_fdata()
    assert vol.shape == src.shape == (24, 24, 15)
    np.testing.assert_array_equal(img.affine, src.affine)
    assert np.isfinite(vol).all() and vol.min() >= 0.0 and vol.max() <= 1.0
    for border in (vol[:8], vol[-8:], vol[:, :8], vol[:, -8:]):
        assert not border.any()
    return img


def test_complete_dataset_matches_jax(tmp_path, ckpt_dir, monkeypatch, capsys):
    """The port's complete_dataset and the JAX package's on one tree (two
    cases without t1c, a complete one, an unreadable one) and one .ckpt:
    the same files per case; the synthesized files agree in shape, affine
    and header dims, with a zero border; the present files byte-identical;
    the unreadable case counted once."""
    monkeypatch.setenv("FAST_CWDM_COMPILE_CACHE", "off")
    inp = _tree(str(tmp_path / "in"), corrupt=True)
    flags = [f"--input_dir={inp}", f"--checkpoint_dir={ckpt_dir}", "--dtype=float32"]
    jcd.main(flags + [f"--output_dir={tmp_path / 'ref'}"])
    assert "done: 3 ok, 1 failed" in capsys.readouterr().out
    res = cd.main(flags + [f"--output_dir={tmp_path / 'ours'}", "--device=cpu"])
    assert "done: 3 ok, 1 failed" in capsys.readouterr().out
    assert res["failed"] == ["00200"] and sorted(res["seconds"]) == ["00000", "00001"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == sorted(os.listdir(inp))
    for case in os.listdir(inp):
        assert sorted(os.listdir(os.path.join(ours, case))) == sorted(os.listdir(os.path.join(ref, case)))
    assert len(os.listdir(os.path.join(ours, "00100"))) == 5  # passed through, nothing added
    _check_passthrough(inp, ours, "00100")
    for case in ("00000", "00001"):
        img = _check_completed(inp, ours, case)
        jimg = jnifti.load(os.path.join(ref, case, f"{case}-t1c.nii.gz"))
        assert img.shape == jimg.shape
        np.testing.assert_array_equal(img.affine, jimg.affine)
        np.testing.assert_array_equal(img.header.dim, jimg.header.dim)
        np.testing.assert_array_equal(img.header.pixdim, jimg.header.pixdim)
        assert not jimg.get_fdata()[:8].any()


def test_complete_dataset_shards(tmp_path, ckpt_dir):
    """--shard: malformed values are refused (the cases of the JAX test
    test_complete_dataset_shard_selection); shards 0/2 and 1/2 write the
    volumes of one unsharded run, bit for bit, since each case draws from
    its own generator."""
    inp = _tree(str(tmp_path / "in"), n_incomplete=3)
    for bad in ("2/2", "3/2", "-1/2", "ab/2", "1"):
        with pytest.raises(SystemExit):
            cd.main([f"--input_dir={inp}", f"--output_dir={tmp_path / 'o'}",
                     f"--checkpoint_dir={ckpt_dir}", "--device=cpu", "--shard", bad])
    base = [f"--input_dir={inp}", f"--checkpoint_dir={ckpt_dir}", "--device=cpu", "--seed=3"]
    whole = cd.main(base + [f"--output_dir={tmp_path / 'whole'}"])
    parts = [cd.main(base + [f"--output_dir={tmp_path / 'sharded'}", f"--shard={i}/2"])
             for i in range(2)]
    assert sorted(whole["seconds"]) == ["00000", "00001", "00002"]
    assert sorted(parts[0]["seconds"]) == ["00000", "00002"] and list(parts[1]["seconds"]) == ["00001"]
    for case in ("00000", "00001", "00002"):
        a = os.path.join(tmp_path, "whole", case, f"{case}-t1c.nii.gz")
        b = os.path.join(tmp_path, "sharded", case, f"{case}-t1c.nii.gz")
        assert filecmp.cmp(a, b, shallow=False)
    vols = [nifti.load(os.path.join(tmp_path, "whole", c, f"{c}-t1c.nii.gz")).get_fdata()
            for c in ("00000", "00001")]
    assert not np.array_equal(vols[0], vols[1])  # per-case streams differ


def test_sample_auto_matches_jax(tmp_path, ckpt_dir, monkeypatch):
    """The port's sample_auto and the JAX package's on one tree and .ckpt:
    the same output files, at the source geometry with a zero border."""
    monkeypatch.setenv("FAST_CWDM_COMPILE_CACHE", "off")
    inp = _tree(str(tmp_path / "in"))
    flags = AUTO_FLAGS + [f"--data_dir={inp}", f"--checkpoint_dir={ckpt_dir}"]
    jsa.main(flags + [f"--output_dir={tmp_path / 'ref'}"])
    res = sa.main(flags + [f"--output_dir={tmp_path / 'ours'}", "--device=cpu"])
    assert (res["done"], res["skipped"], res["failed"]) == (2, 1, 0)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == ["00000", "00001"]
    for case in ("00000", "00001"):
        assert os.listdir(os.path.join(ours, case)) == os.listdir(os.path.join(ref, case))
        img = nifti.load(os.path.join(ours, case, f"{case}-t1c.nii.gz"))
        jimg = jnifti.load(os.path.join(ref, case, f"{case}-t1c.nii.gz"))
        vol = img.get_fdata()
        assert vol.shape == jimg.shape == (24, 24, 15)
        np.testing.assert_array_equal(img.affine, jimg.affine)
        assert np.isfinite(vol).all() and 0.0 <= vol.min() and vol.max() <= 1.0
        assert not vol[:8].any() and not vol[:, -8:].any()
        assert np.all((vol == 0) | (vol > 0.04))  # the threshold


def test_unprocess_and_header_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for vol, raw in ((rng.random((224, 224, 160, 1), np.float32), None),
                     (rng.random((8, 8, 160), np.float32), (24, 24, 15)),
                     (rng.random((8, 8, 12), np.float32), None)):
        ours, ref = brats.unprocess_volume(vol, raw), jbrats.unprocess_volume(vol, raw)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape and np.array_equal(ours, ref)
    _make_case(str(tmp_path / "c"))
    for name in sorted(os.listdir(tmp_path / "c")):
        path = str(tmp_path / "c" / name)
        for p in (path, path[:-3]):
            if p != path:  # an uncompressed copy
                nifti.save(nifti.load(path), p)
            ours, ref = nifti.load_header(p), jnifti.load_header(p)
            assert ours.shape == ref.shape and np.array_equal(ours.affine, ref.affine)
            for f in ("dim", "pixdim", "srow", "datatype", "sform_code", "raw"):
                assert np.array_equal(getattr(ours.header, f), getattr(ref.header, f)), f


def test_threaded_loader_keeps_order_and_raises():
    """Items in index order whatever their load times, at most max_prefetch
    in flight; a failing item raises; the JAX package's loader agrees."""
    lock, state = threading.Lock(), {"now": 0, "peak": 0}

    class Slow:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            with lock:
                state["now"] += 1
                state["peak"] = max(state["peak"], state["now"])
            time.sleep(0.002 * ((i * 7) % 5))
            with lock:
                state["now"] -= 1
            if i == 30:
                raise OSError("unreadable")
            return i * i

    assert list(ThreadedLoader(Slow(), num_workers=4, max_prefetch=3)) == [i * i for i in range(23)]
    assert state["peak"] <= 3
    assert list(ThreadedLoader(Slow(), num_workers=3)) == list(jloader.ThreadedLoader(Slow(), num_workers=3))
    assert list(ThreadedLoader([], num_workers=2)) == []

    class Broken(Slow):
        def __len__(self):
            return 40

    with pytest.raises(RuntimeError, match="item 30"):
        list(ThreadedLoader(Broken(), num_workers=4))


def test_clis_refuse_to_fall_back_to_cpu(tmp_path, ckpt_dir):
    """Without a GPU both CLIs raise unless --device cpu is given, before
    writing anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    inp = _tree(str(tmp_path / "in"), n_incomplete=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        cd.main([f"--input_dir={inp}", f"--output_dir={tmp_path / 'a'}", f"--checkpoint_dir={ckpt_dir}"])
    with pytest.raises(RuntimeError, match="no GPU"):
        sa.main(AUTO_FLAGS + [f"--data_dir={inp}", f"--checkpoint_dir={ckpt_dir}",
                              f"--output_dir={tmp_path / 'b'}"])
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
