"""The port's TrainLoop and ``cli.train`` on the CPU: the loop under
``DIFFUSION_TRAINING_TEST``, the CLI on a tiny synthetic BraTS tree (then
synthesis from the BEST it wrote) and on LIDC volumes, the training data
paths against the JAX package's (host batches, device-resident batches),
the checkpoint helpers (optimizer names, pruning, the best ledger, the
background writer), resume across the two packages in both directions (a JAX-written
BEST and optimizer blob resume in the port, and its next step matches
JAX's; the port's blobs load in JAX's ``load_checkpoint`` with JAX's own
template, byte for byte), and SIGTERM preemption (exit 143, a step-stamped
checkpoint that resumes with its optimizer state).

Tolerances of the cross-package step: as tests/test_torch_training.py
(Adam eps 1e-3 on both sides; parameters 5e-3·lr plus two ulps).
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.data import brats as jbrats
from fast_cwdm_tpu.data import loader as jloader
from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from fast_cwdm_tpu.models import UNetModel as JUNet
from fast_cwdm_tpu.training import TrainLoop as JTrainLoop
from fast_cwdm_tpu.training import checkpoints as jckpt
from fast_cwdm_tpu.training.bridge import flax_to_torch, torch_to_flax
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.cli import train as cli_train
from fast_cwdm_tpu_torch.data import brats, loader, nifti
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training.loop import TrainLoop
from fast_cwdm_tpu_torch.utils import logger
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODALITIES = ("t1n", "t1c", "t2w", "t2f")
LR, EPS = 1e-4, 1e-3
TINY = dict(in_channels=32, model_channels=16, out_channels=8, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3, num_groups=8,
            resblock_updown=True, bottleneck_attention=False, resample_2d=False, image_size=8)
# the same model through the CLI's flags
TINY_FLAGS = ["--num_channels=16", "--num_res_blocks=1", "--channel_mult=1,2",
              "--attention_resolutions=", "--num_groups=8", "--bottleneck_attention=False",
              "--image_size=8", "--resample_2d=False", "--use_scale_shift_norm=False",
              "--resblock_updown=True", "--mode=i2i", "--dtype=float32",
              "--diffusion_steps=10", "--sample_schedule=sampled", "--device=cpu"]


@pytest.fixture(autouse=True)
def _quiet_logger(tmp_path):
    logger.configure(str(tmp_path / "log"), ["log", "csv"])


def _models():
    model = UNetModel(**TINY)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jmodel = JUNet(**TINY)
    return model, jmodel, torch_to_flax(sd, jmodel)


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {m: rng.random((b, 8, 8, 8, 1)).astype(np.float32) for m in MODALITIES}


def _diffusions():
    return (GaussianDiffusion.named("linear", 10, "sampled", mode="i2i"),
            JDiffusion.named("linear", 10, "sampled", mode="i2i"))


def _loop_kw(tmp_path, **over):
    kw = dict(batch_size=2, lr=LR, ema_rate="0.99", log_interval=1, save_interval=2,
              mode="i2i", contr="t1n", sample_schedule="sampled", diffusion_steps=10,
              checkpoint_dir=str(tmp_path), lr_anneal_steps=6, seed=3)
    kw.update(over)
    return kw


def _port_loop(tmp_path, batch, model=None, **over):
    model = model or _models()[0]
    diffusion, _ = _diffusions()
    loop = TrainLoop(model=model, diffusion=diffusion, data=lambda: iter([batch]),
                     device="cpu", prefetch=0, **_loop_kw(tmp_path, **over))
    loop.opt.eps = EPS
    return loop


_JAX_STEPS: dict = {}  # lr_anneal_steps → (tx, jitted step): one compile per module


def _jax_loop(tmp_path, batch, **over):
    _, jmodel, _ = _models()
    _, jdiff = _diffusions()
    loop = JTrainLoop(model=jmodel, diffusion=jdiff, data=lambda: iter([batch]), prefetch=0,
                      **_loop_kw(tmp_path, **over))
    # the same eps as the port's loop (see the module docstring)
    from fast_cwdm_tpu.training.train import make_optimizer, make_train_step

    if loop.lr_anneal_steps not in _JAX_STEPS:
        tx = make_optimizer(LR, lr_anneal_steps=loop.lr_anneal_steps, eps=EPS)
        _JAX_STEPS[loop.lr_anneal_steps] = (tx, make_train_step(
            jmodel, jdiff, tx, contr="t1n", mode="i2i", sampler=loop.sampler, donate=False))
    loop.tx, loop.step_fn = _JAX_STEPS[loop.lr_anneal_steps]
    return loop


def _make_case(case_dir, shape=(24, 24, 8), seed=0):
    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = os.path.basename(case_dir)
    for m in MODALITIES:
        vol = (rng.random(shape) * 900 + 100).astype(np.float32)
        nifti.save(nifti.Nifti1Image(vol, np.eye(4)),
                   os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))
    seg = rng.choice([0, 1, 2, 4], size=shape).astype(np.int16)
    nifti.save(nifti.Nifti1Image(seg, np.eye(4)), os.path.join(case_dir, f"BraTS-GLI-{base}-000-seg.nii.gz"))


def _equal(ours: dict, jtree, jmodel):
    ref = flax_to_torch(jax.tree.map(np.asarray, jtree), jmodel)
    assert set(ref) == set(ours)
    for k in ref:
        assert np.array_equal(np.asarray(ours[k].detach()), ref[k]), k


def _close(ours: dict, jtree, jmodel, atol, rtol=0.0):
    ref = flax_to_torch(jax.tree.map(np.asarray, jtree), jmodel)
    assert set(ref) == set(ours)
    worst = max(float((np.abs(np.asarray(ours[k].detach()) - ref[k])
                       / (atol + rtol * np.abs(ref[k]))).max()) for k in ref)
    assert worst <= 1.0, worst


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_training_batches_match_jax(tmp_path, monkeypatch):
    """BRATSVolumes(mode="train", cache, with_seg) and iterate_batches (with
    threads and rows) give the JAX package's batches bit for bit, both on
    the float64 decode (the JAX package's numpy reader; the port's path for
    a datatype the C++ decoder does not read; the float32 default is held to
    JAX in test_torch_phantom.py); load_seg keeps the raw labels; a case
    missing a modality raises, naming it."""
    monkeypatch.setenv("FAST_CWDM_NATIVE", "0")
    monkeypatch.setattr(brats, "_load_float32", lambda path: None)
    for i in range(3):
        _make_case(str(tmp_path / "data" / f"0000{i}"), seed=i)
    os.remove(next(p for p in (tmp_path / "data" / "00002").iterdir() if "-seg." in p.name))
    ours = brats.BRATSVolumes(str(tmp_path / "data"), mode="train", cache=True, with_seg=True)
    theirs = jbrats.BRATSVolumes(str(tmp_path / "data"), mode="train", with_seg=True)
    assert len(ours) == len(theirs) == 3
    keys = MODALITIES + ("seg",)
    for workers in (0, 2):
        a = list(brats.iterate_batches(ours, 2, shuffle=True, seed=4, keys=keys,
                                       num_workers=workers))
        b = list(jbrats.iterate_batches(theirs, 2, shuffle=True, seed=4, keys=keys))
        assert len(a) == len(b) == 1
        for k in keys:
            assert a[0][k].dtype == b[0][k].dtype and np.array_equal(a[0][k], b[0][k]), k
    assert set(np.unique(ours[0]["seg"])) <= {0, 1, 2, 4} and not ours[2]["seg"].any()
    assert ours[0]["t1n"] is ours[0]["t1n"]  # cached
    order = np.arange(7)
    for rows in ((0, 1), (1, 3)):
        got, bs = loader.shard_order_rows(order, 3, rows)
        want, jbs = jloader.shard_order_rows(order, 3, rows)
        assert bs == jbs and np.array_equal(got, want)
    with pytest.raises(ValueError):
        loader.shard_order_rows(order, 3, (2, 5))
    os.remove(next(p for p in (tmp_path / "data" / "00001").iterdir() if "-t2w." in p.name))
    with pytest.raises(ValueError, match="missing modality 't2w'"):
        list(brats.iterate_batches(brats.BRATSVolumes(str(tmp_path / "data")), 3))


def test_device_resident_batches_match_iterate_batches(tmp_path, monkeypatch):
    """device_resident_batches yields iterate_batches' sequence, decodes each
    case once across epochs (the cache), and names a case missing a
    modality."""
    for i in range(3):
        _make_case(str(tmp_path / "data" / f"0000{i}"), seed=i)
    ds = brats.BRATSVolumes(str(tmp_path / "data"), with_seg=True)
    calls = []
    getitem = brats.BRATSVolumes.__getitem__
    monkeypatch.setattr(brats.BRATSVolumes, "__getitem__",
                        lambda self, i: calls.append(i) or getitem(self, i))
    keys = MODALITIES + ("seg",)
    cache: dict = {}
    decoded = []
    for epoch, bs in ((0, 1), (1, 2)):
        n = len(calls)
        got = list(loader.device_resident_batches(ds, bs, device="cpu", shuffle=True,
                                                  seed=epoch, keys=keys, cache=cache))
        decoded.append(sorted(calls[n:]))
        want = list(brats.iterate_batches(ds, bs, shuffle=True, seed=epoch, keys=keys))
        assert len(got) == len(want) == (3 if bs == 1 else 1)
        for g, w in zip(got, want):
            for k in keys:
                assert g[k].device.type == "cpu" and np.array_equal(g[k].numpy(), w[k]), k
    assert decoded == [[0, 1, 2], []]  # the second epoch comes from the cache
    os.remove(next(p for p in (tmp_path / "data" / "00001").iterdir() if "-t1c." in p.name))
    with pytest.raises(ValueError, match="missing modality 't1c'"):
        list(loader.device_resident_batches(brats.BRATSVolumes(str(tmp_path / "data")), 1,
                                            device="cpu"))


def test_lidc_volumes_match_jax_and_train(tmp_path, monkeypatch):
    """LIDCVolumes gives the JAX package's half-resolution volumes, and
    cli.train --dataset lidc-idri trains the unconditional model on them
    (--mode default) to a BEST."""
    rng = np.random.default_rng(5)
    for i in range(2):
        d = tmp_path / "lidc" / f"case{i}"
        d.mkdir(parents=True)
        nifti.save(nifti.Nifti1Image((rng.random((16, 16, 16)) * 2000 - 1000).astype(np.float32),
                                     np.eye(4)), str(d / f"ct{i}.nii.gz"))
    ours = brats.LIDCVolumes(str(tmp_path / "lidc"))
    theirs = jbrats.LIDCVolumes(str(tmp_path / "lidc"))
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        assert ours[i].shape == (8, 8, 8, 1) and np.array_equal(ours[i], theirs[i])
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    monkeypatch.setenv("OPENAI_LOGDIR", str(tmp_path / "log"))
    ck = tmp_path / "ck"
    loop = cli_train.main([f"--data_dir={tmp_path / 'lidc'}", "--dataset=lidc-idri",
                           "--batch_size=2", "--log_interval=1", "--save_interval=1",
                           f"--checkpoint_dir={ck}", *TINY_FLAGS, "--mode=default"])
    assert loop.model.in_channels == 8 and loop.state.step == 1
    assert ckpt.find_best_checkpoint(str(ck), "t1n", dataset="lidc-idri") is not None
    with pytest.raises(ValueError, match="seg labels"):
        cli_train.main([f"--data_dir={tmp_path / 'lidc'}", "--dataset=lidc-idri",
                        "--lesion_weight=1", *TINY_FLAGS])


def test_async_writer(tmp_path):
    """A write through an AsyncWriter has the synchronous write's bytes, holds
    the values of the moment it was submitted (a CPU tensor changed in
    place afterwards does not reach the file), and a failed write raises on
    the next wait."""
    w = ckpt.AsyncWriter()
    t = torch.arange(6, dtype=torch.float32)
    payload = {"params": {"w": t, "b": np.ones(2, np.float32)}, "step": 3}
    ckpt.save_checkpoint(str(tmp_path / "sync.ckpt"), payload)
    ckpt.save_checkpoint(str(tmp_path / "async.ckpt"), payload, writer=w)
    t.add_(100.0)
    w.wait()
    assert (tmp_path / "sync.ckpt").read_bytes() == (tmp_path / "async.ckpt").read_bytes()
    (tmp_path / "file").write_text("")
    ckpt.save_checkpoint(str(tmp_path / "file" / "x.ckpt"), payload, writer=w)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        w.wait()
    w.wait()  # the error is raised once


def test_prefetch_to_device_keeps_order_and_raises():
    def items():
        yield {"a": np.zeros((2, 3), np.float32)}
        yield {"a": np.ones((2, 3), np.float32)}
        raise OSError("disk")

    got = loader.prefetch_to_device(items(), size=1, device="cpu")
    assert float(next(got)["a"].sum()) == 0.0 and float(next(got)["a"].sum()) == 6.0
    with pytest.raises(OSError, match="disk"):
        next(got)


# ---------------------------------------------------------------------------
# Checkpoint helpers
# ---------------------------------------------------------------------------


def test_checkpoint_names_pruning_and_ledger(tmp_path):
    """opt_checkpoint_name as JAX's; prune_step_checkpoints removes this
    run's older step blobs only; save_if_best keeps one BEST with its opt
    blob and sidecar, refuses a worse or non-finite loss and heals a
    non-finite ledger entry."""
    assert ckpt.opt_checkpoint_name("t1n", 12, "sampled", 10) == jckpt.opt_checkpoint_name(
        "t1n", 12, "sampled", 10)
    d = str(tmp_path)
    names = [ckpt.step_checkpoint_name("t1n", s, "sampled", 10) for s in (1, 2, 3)]
    names += [ckpt.opt_checkpoint_name("t1n", s, "sampled", 10) for s in (1, 3)]
    names += [ckpt.step_checkpoint_name("t1n", 1, "direct", 1000),
              ckpt.step_checkpoint_name("t1c", 1, "sampled", 10),
              ckpt.best_checkpoint_name("t1n", "sampled", 10)]
    for n in names:
        open(os.path.join(d, n), "wb").close()
    removed = ckpt.prune_step_checkpoints(d, "t1n", 3, "sampled", 10)
    assert sorted(os.path.basename(p) for p in removed) == sorted(names[:2] + names[3:4])
    assert jckpt.prune_step_checkpoints(d, "t1n", 3, "sampled", 10) == []

    payload = {"params": {"w": np.ones(3, np.float32)}, "ema_params": (), "step": 4}
    opt = {"opt_state": ({"count": np.asarray(4, np.int32)}, {}, {})}
    kw = dict(sample_schedule="sampled", diffusion_steps=10, config={"contr": "t2w"})
    d2 = str(tmp_path / "best")
    assert ckpt.save_if_best(d2, "t2w", 0.5, payload, opt, **kw)
    assert not ckpt.save_if_best(d2, "t2w", 0.7, payload, opt, **kw)
    assert not ckpt.save_if_best(d2, "t2w", float("nan"), payload, opt, **kw)
    assert ckpt.save_if_best(d2, "t2w", 0.25, payload, opt, **kw)
    assert sorted(os.listdir(d2)) == ["best_losses.txt", "brats_t2w_BEST_sampled_10.ckpt",
                                      "brats_t2w_BEST_sampled_10.ckpt.json", "opt_best_t2w.ckpt"]
    assert jckpt.load_best_losses(d2) == {"t2w": 0.25}
    ckpt.save_best_losses(d2, {"t2w": float("nan")})
    assert ckpt.save_if_best(d2, "t2w", 0.9, payload, None, **kw)


# ---------------------------------------------------------------------------
# The loop and the CLI
# ---------------------------------------------------------------------------


def test_trainloop_smoke_with_the_test_hook(tmp_path, monkeypatch):
    """DIFFUSION_TRAINING_TEST: two steps, one BEST save with its opt blob
    and sidecar, then return; every logged loss finite, one record per log
    step."""
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    batch = _batch()
    loop = _port_loop(tmp_path, batch, lr_anneal_steps=0)
    state = loop.run_loop()
    assert state.step == 2 and not loop.preempted
    assert [r["step"] for r in loop.step_log] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in loop.step_log)
    found = ckpt.find_best_checkpoint(str(tmp_path), "t1n")
    assert found and found[1:] == ("sampled", 10)
    assert ckpt.load_checkpoint_config(found[0])["step"] == 2
    assert os.path.exists(tmp_path / "opt_best_t1n.ckpt")
    assert os.path.exists(tmp_path / "log" / "progress.csv")


def test_strict_finite_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("FAST_CWDM_STRICT_FINITE", "1")
    batch = _batch()
    batch["t1n"][0, 0, 0, 0, 0] = np.nan
    loop = _port_loop(tmp_path, batch)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        loop.run_loop()


def test_cli_train_on_a_synthetic_tree_then_sample(tmp_path, monkeypatch):
    """cli.train with run.sh's TRAIN flags (lr 1e-5, batch 1,
    use_checkpoint) on two tiny cases under DIFFUSION_TRAINING_TEST: a BEST
    whose sidecar holds the config, its opt blob, the ledger; then
    load_best_synthesis builds the model from it and synthesizes a volume.
    Also: --device_cache gives the same losses, the mesh flags' refusal,
    and the default device."""
    for i in range(2):
        _make_case(str(tmp_path / "data" / f"0000{i}"), seed=i)
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    monkeypatch.setenv("OPENAI_LOGDIR", str(tmp_path / "log"))
    ck = tmp_path / "ck"
    argv = [f"--data_dir={tmp_path / 'data'}", "--lr=1e-5", "--batch_size=1",
            "--log_interval=1", "--save_interval=2", "--lr_anneal_steps=4",
            "--use_checkpoint=True", "--num_workers=2", f"--checkpoint_dir={ck}",
            "--contr=t1c", "--cache_dataset=True", *TINY_FLAGS]
    loop = cli_train.main(argv)
    assert loop.state.step == 2 and not loop.preempted
    assert any(getattr(m, "remat", False) for m in loop.model.modules())
    path, schedule, steps = ckpt.find_best_checkpoint(str(ck), "t1c")
    cfg = ckpt.load_checkpoint_config(path)
    assert (schedule, steps, cfg["contr"], cfg["use_checkpoint"]) == ("sampled", 10, "t1c", True)
    assert os.path.exists(ck / "opt_best_t1c.ckpt") and os.path.exists(ck / "best_losses.txt")
    run = common.load_best_synthesis(str(ck), "t1c", base_cfg=common.production_config(),
                                     device="cpu")
    item = brats.BRATSVolumes(str(tmp_path / "data"))[0]
    batch = {m: item[m][None] for m in MODALITIES}
    out = run(common.prepare_condition(batch, "t1c", device="cpu"), batch["t1n"],
              torch.Generator().manual_seed(0))
    assert out.shape == (1, 8, 8, 155) and np.isfinite(out).all()
    # one process is a data axis of 1: --data_mesh=2 needs torchrun's two
    # ranks, and --spatial_mesh=2 two ranks as well
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        cli_train.main(argv + ["--data_mesh=2"])
    with pytest.raises(ValueError, match="not divisible by sp"):
        cli_train.main(argv + ["--spatial_mesh=2"])
    # the dataset kept in device memory: the same steps from the same seed
    cached = cli_train.main(argv + ["--device_cache=True", f"--checkpoint_dir={tmp_path / 'ck2'}"])
    assert [r["loss"] for r in cached.step_log] == [r["loss"] for r in loop.step_log]
    assert cli_train.create_argparser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            cli_train.main(argv[:-1])  # the default device


# ---------------------------------------------------------------------------
# Resume across the packages
# ---------------------------------------------------------------------------


def _next_steps(jloop, ploop, batch, n=1, seed=21):
    """n steps of both loops' step functions on JAX's draws."""
    key = jax.random.PRNGKey(seed)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(n):
        key, sub = jax.random.split(key)
        key_t, key_noise, _ = jax.random.split(sub, 3)
        t = torch.from_numpy(np.array(jax.random.randint(key_t, (2,), 0, 10))).long()
        noise = torch.from_numpy(np.array(jax.random.normal(key_noise, batch["t1n"].shape)))
        jloop.state, jm = jloop.step_fn(jloop.state, jbatch, sub)
        ploop.state, pm = ploop.step_fn(ploop.state, tbatch, t=t, noise_img=noise)
    return jm, pm


def _check_states(jloop, ploop, jm, pm, jmodel):
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), atol=2e-5)
    assert ploop.state.opt_state["count"] == int(jloop.state.opt_state[0].count)
    _close(dict(ploop.model.named_parameters()), jloop.state.params, jmodel, 5e-3 * LR, 2.0**-22)
    for ours, theirs in zip(ploop.state.ema_params, jloop.state.ema_params, strict=True):
        _close(ours, theirs, jmodel, 5e-3 * LR, 2.0**-22)


def test_jax_best_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX TrainLoop trains 2 steps (anneal over 6) and writes its BEST
    and opt_best; the port's TrainLoop resumes from them (params, EMA
    shadow, Adam moments and count), and its next step matches the JAX
    loop's next step from the same files."""
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    batch = _batch(1)
    _, jmodel, _ = _models()
    _jax_loop(tmp_path, batch).run_loop()
    jckpt.wait_for_pending_saves()
    best = jckpt.find_best_checkpoint(str(tmp_path), "t1n")[0]
    jloop = _jax_loop(tmp_path, batch, resume_checkpoint=best)
    jloop.state = jloop._init_state(batch)
    jloop._apply_resume()
    ploop = _port_loop(tmp_path, batch, resume_checkpoint=best)
    ploop.state = ploop._init_state({k: torch.from_numpy(v) for k, v in batch.items()})
    ploop._apply_resume()
    assert ploop.resume_step == jloop.resume_step == 2
    assert ploop.state.opt_state["count"] == int(jloop.state.opt_state[0].count) == 2
    _equal(ploop.state.opt_state["nu"], jloop.state.opt_state[0].nu, jmodel)
    _equal(ploop.state.ema_params[0], jloop.state.ema_params[0], jmodel)
    _check_states(jloop, ploop, *_next_steps(jloop, ploop, batch), jmodel)


def test_port_checkpoints_load_in_jax_and_resume(tmp_path, monkeypatch):
    """The port's loop trains 2 steps and writes its BEST, opt_best, and a
    step-stamped pair. JAX's load_checkpoint reads each with JAX's own
    template; JAX's writer gives the same bytes for what it read; and the
    JAX loop resumed from the port's BEST steps as the port resumed from
    it."""
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    batch = _batch(2)
    _, jmodel, params = _models()
    loop = _port_loop(tmp_path, batch)
    loop.run_loop()
    loop.save(2)
    tx = _jax_loop(tmp_path, batch).tx
    template = {"params": params, "ema_params": (params,), "step": 0}
    opt_template = {"opt_state": tx.init(params)}
    files = [(ckpt.find_best_checkpoint(str(tmp_path), "t1n")[0], template),
             (str(tmp_path / "opt_best_t1n.ckpt"), opt_template),
             (str(tmp_path / ckpt.step_checkpoint_name("t1n", 2, "sampled", 10)), template),
             (str(tmp_path / ckpt.opt_checkpoint_name("t1n", 2, "sampled", 10)), opt_template)]
    for path, tmpl in files:
        got = jckpt.load_checkpoint(path, tmpl)
        again = str(tmp_path / "again.ckpt")
        jckpt.save_checkpoint(again, got)
        with open(path, "rb") as f, open(again, "rb") as g:
            assert f.read() == g.read(), path
    got = jckpt.load_checkpoint(files[1][0], opt_template)["opt_state"]
    assert int(got[0].count) == int(got[2].count) == 2
    _equal(loop.state.opt_state["mu"], got[0].mu, jmodel)

    best = files[0][0]
    jloop = _jax_loop(tmp_path, batch, resume_checkpoint=best)
    jloop.state = jloop._init_state(batch)
    jloop._apply_resume()
    ploop = _port_loop(tmp_path, batch, resume_checkpoint=best)
    ploop.state = ploop._init_state({k: torch.from_numpy(v) for k, v in batch.items()})
    ploop._apply_resume()
    _check_states(jloop, ploop, *_next_steps(jloop, ploop, batch), jmodel)


def test_step_checkpoint_resume_prefers_its_opt_blob(tmp_path, monkeypatch):
    """A step-stamped checkpoint resumes with its own opt blob, not
    opt_best; without one the loop warns and restores opt_best; the
    reference's bare opt{step:06d} is found too."""
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    batch = _batch(3)
    loop = _port_loop(tmp_path, batch, lr_anneal_steps=0, save_interval=1)
    loop.run_loop()  # BEST and opt_best at step 1
    monkeypatch.delenv("DIFFUSION_TRAINING_TEST")
    loop.lr_anneal_steps = 3
    loop.run_loop()  # steps 2-3, saves at each (the loss may not improve)
    loop.save(3)
    path = str(tmp_path / ckpt.step_checkpoint_name("t1n", 3, "sampled", 10))

    def resumed():
        r = _port_loop(tmp_path, batch, resume_checkpoint=path, lr_anneal_steps=0)
        r.state = r._init_state({k: torch.from_numpy(v) for k, v in batch.items()})
        r._apply_resume()
        return r

    r = resumed()
    assert r.resume_step == 3 and r.state.opt_state["count"] == loop.state.opt_state["count"]
    for k, v in loop.state.opt_state["mu"].items():
        assert torch.equal(r.state.opt_state["mu"][k], v)
    opt3 = tmp_path / ckpt.opt_checkpoint_name("t1n", 3, "sampled", 10)
    os.rename(opt3, tmp_path / "opt000003.ckpt")
    assert resumed().state.opt_state["count"] == loop.state.opt_state["count"]
    os.remove(tmp_path / "opt000003.ckpt")
    r = resumed()
    log = open(tmp_path / "log" / "log.txt").read()
    assert "WARNING: no step-3 opt blob" in log
    assert r.state.opt_state["count"] == int(np.asarray(
        ckpt.load_checkpoint(str(tmp_path / "opt_best_t1n.ckpt"))["opt_state"]["0"]["count"]))


_PREEMPT_CHILD = r"""
import sys
from fast_cwdm_tpu_torch.cli import train
sys.exit(143 if train.main(sys.argv[1:]).preempted else 0)
"""


def test_sigterm_preemption_exits_143_with_a_resumable_checkpoint(tmp_path):
    """cli.train in a child process, SIGTERM after its first logged step:
    the step in flight finishes, a step-stamped checkpoint and its opt blob
    are written, the process exits 143; the checkpoint resumes with that
    optimizer state."""
    _make_case(str(tmp_path / "data" / "00000"))
    ck = tmp_path / "ck"
    argv = [f"--data_dir={tmp_path / 'data'}", "--lr=1e-4", "--batch_size=1",
            "--log_interval=1", "--save_interval=1000", f"--checkpoint_dir={ck}",
            "--cache_dataset=True", *TINY_FLAGS]
    env = dict(os.environ, PYTHONPATH=REPO, OPENAI_LOGDIR=str(tmp_path / "log"),
               OMP_NUM_THREADS="2")
    p = subprocess.Popen([sys.executable, "-c", _PREEMPT_CHILD, *argv], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        line = ""
        while time.time() < deadline and "[PROFILE] Step" not in line:
            line = p.stdout.readline()
            if not line and p.poll() is not None:
                break
        assert "[PROFILE] Step" in line, p.stderr.read()[-2000:]
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 143, err[-2000:]
    steps = [ckpt.parse_resume_step_from_filename(f) for f in os.listdir(ck)
             if f.startswith("brats_t1n_") and f.endswith(".ckpt")]
    assert len(steps) == 1 and steps[0] >= 1, os.listdir(ck)
    step = steps[0]
    assert os.path.exists(ck / ckpt.opt_checkpoint_name("t1n", step, "sampled", 10))
    assert not os.path.exists(ck / "opt_best_t1n.ckpt")  # no BEST save ran
    model, diffusion = common.build_model_and_diffusion(common.production_config(
        num_channels=16, num_res_blocks=1, channel_mult="1,2", attention_resolutions="",
        num_groups=8, image_size=8, diffusion_steps=10, sample_schedule="sampled",
        dtype="float32"))
    r = TrainLoop(model=model, diffusion=diffusion, data=lambda: iter([]), batch_size=1,
                  resume_checkpoint=str(ck / ckpt.step_checkpoint_name("t1n", step, "sampled", 10)),
                  contr="t1n", sample_schedule="sampled", diffusion_steps=10,
                  checkpoint_dir=str(ck), device="cpu", prefetch=0)
    r.state = r._init_state({m: torch.zeros(1, 8, 8, 160, 1) for m in MODALITIES})
    r._apply_resume()
    assert r.resume_step == step and r.state.opt_state["count"] == step
