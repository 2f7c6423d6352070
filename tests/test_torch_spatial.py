"""The port's sp axis (a volume's Y axis split over the ranks of an sp
group, ``parallel/mesh.py``) on the CPU: ``gloo`` ranks in child processes
against the JAX package unsharded and the port's one process.

- one 4-rank job on the meshes ``(data 2, sp 2)`` and ``(data 1, sp 4)``:
  the mesh's indices and groups, ``halo_exchange`` / ``halo_pad`` and their
  adjoint, ``group_stats`` and ``GroupNorm32``, the UNet forward (fp32 at
  S = 2 and 4 on a config whose level-2 slab goes odd at S = 4, so the
  gather and the re-shard run; bf16 ``fuse_conv`` at S = 2), gradients
  under ``use_checkpoint``, ``make_synthesis_fn`` (ddpm and dpm++) and a
  train step at ``(data 2, sp 2)``;
- one 2-rank job at ``(data 1, sp 2)``: a train step, and
  ``cli.train --spatial_mesh 2`` (two steps, a BEST, a resume);
- one process: the Haar-only wavelet rule and its slab check.

The children import no JAX; the JAX side runs here while they run.
Tolerances: forwards 5e-5 (fp32) and ``tests/test_torch_unet.py``'s bf16
bound; synthesis 1e-5 (``tests/test_parallel.py:279``); losses rtol 2e-5
and ``mse_wav`` 2e-4 (``tests/test_parallel.py:92``); parameters after one
AdamW step within 5e-3·lr of the port's one process; statistics 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.cli import common as jcommon
from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from fast_cwdm_tpu.models import UNetModel as JUNet
from fast_cwdm_tpu.training import TrainState as JTrainState
from fast_cwdm_tpu.training import make_optimizer as jmake_optimizer
from fast_cwdm_tpu.training import make_train_step as jmake_train_step
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.cli import train as cli_train
from fast_cwdm_tpu_torch.data import nifti
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.parallel import dryrun
from fast_cwdm_tpu_torch.parallel import mesh as pmesh
from fast_cwdm_tpu_torch.training import state as tstate
from fast_cwdm_tpu_torch.training import train
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

TIMEOUT = 240
MODALITIES = ("t1n", "t1c", "t2w", "t2f")
LR, EPS = 1e-4, 1e-3
# latent Y 16 with three downsamples: slabs 8 → 4 → 2 at S = 2, and
# 4 → 2 → 1 at S = 4, where level 3 runs whole on every rank
FWD_CFG = dict(image_size=8, in_channels=16, model_channels=16, out_channels=8,
               num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2, 2, 2), dims=3,
               num_groups=8, resblock_updown=True, bottleneck_attention=False,
               resample_2d=False)
FUSE_CFG = dict(FWD_CFG, in_channels=32, model_channels=32)
LATENT = (1, 8, 16, 8)  # (B, X, Y, Z) of the forward tests' input
# tests/test_parallel.py's tiny model and sizes (synthesis: batch 4 of 16³,
# 4 ddpm steps; the step: 8³ volumes)
TINY = dict(image_size=8, in_channels=32, model_channels=16, out_channels=8, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3, num_groups=8,
            resblock_updown=True, bottleneck_attention=False, resample_2d=False)
TINY_FLAGS = ["--num_channels=16", "--num_res_blocks=1", "--channel_mult=1,2",
              "--attention_resolutions=", "--num_groups=8", "--bottleneck_attention=False",
              "--image_size=8", "--resample_2d=False", "--use_scale_shift_norm=False",
              "--resblock_updown=True", "--mode=i2i", "--dtype=float32",
              "--diffusion_steps=10", "--sample_schedule=sampled", "--device=cpu"]
BF16_FACTOR = 2.0  # tests/test_torch_unet.py


def _seeded(model):
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()


def _x(cfg):
    """The forward tests' channels-last input."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((*LATENT, cfg["in_channels"])).astype(np.float32)


def _volumes(b, size, seed):
    rng = np.random.default_rng(seed)
    return {m: rng.random((b, size, size, size, 1), dtype=np.float32) for m in MODALITIES}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _four(work):
    """The 4-rank job (run in the child)."""
    import torch.nn.functional as F

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.models.nn import GroupNorm32
    from fast_cwdm_tpu_torch.ops.conv3d_cuda import group_stats
    from fast_cwdm_tpu_torch.parallel import mesh as pm

    inputs = np.load(os.path.join(work, "inputs.npz"))
    m22, m14 = pm.make_mesh(data=2, sp=2), pm.make_mesh(sp=4)
    r = m22.process_rank
    out, arrays = {}, {}
    one = torch.tensor([float(r)])
    out["mesh"] = dict(
        shape=m22.shape, rank=m22.rank, sp_rank=m22.sp_rank, process_rank=r,
        data_gather=pm.all_gather_rows(m22, one).tolist(),
        sp_sum=float(pm.all_reduce_sum_sp(one, m22.sp_axis)),
        sp_gather=pm.all_gather_sp(one, 0, m14.sp_axis).tolist(),
        any=[pm.any_rank(m22, r == 3), pm.any_rank(m22, False)],
        shape14=m14.shape, sp_rank14=m14.sp_rank,
        rows=pm.local_batch_rows(m22, 4), slab=pm.y_slab(m22, 8),
        shard=pm.shard_batch(m22, np.arange(2 * 3 * 8).reshape(2, 3, 8).astype(np.float32),
                             device="cpu").tolist())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 8, 4)).astype(np.float32))
    gn_x = torch.from_numpy(rng.standard_normal((2, 16, 4, 8, 6)).astype(np.float32) + 0.5)
    norm = _seeded(GroupNorm32(8, 16))
    errs = {}
    for S, mesh in ((2, m22), (4, m14)):
        ax = mesh.sp_axis
        y0, y1 = pm.y_slab(ax, 8)
        for w in (1, 2) if 8 // S >= 2 else (1,):
            xs = x[:, :, :, y0:y1].clone().requires_grad_()
            ext, lo, hi = pm.halo_exchange(xs, 3, w, ax)
            padded = F.pad(x, (0, 0, w, w))
            errs[f"halo{S}.{w}.fwd"] = float((ext - x[:, :, :, y0 - lo:y1 + hi]).abs().max())
            errs[f"halo{S}.{w}.shape"] = list(ext.shape) == [2, 3, 5, y1 - y0 + lo + hi, 4]
            pad = pm.halo_pad(x[:, :, :, y0:y1], 3, w, ax)
            errs[f"halo{S}.{w}.pad"] = float((pad - padded[:, :, :, y0:y1 + 2 * w]).abs().max())
            # the adjoint: every rank's window of one global cotangent
            g = torch.from_numpy(np.random.default_rng(7).standard_normal(
                padded.shape).astype(np.float32))
            (ext * g[:, :, :, y0 + w - lo:y1 + w + hi]).sum().backward()
            xr = x.clone().requires_grad_()
            pr = F.pad(xr, (0, 0, w, w))
            n = 8 // S
            total = sum((pr[:, :, :, a * n + w - (w if a else 0):(a + 1) * n + w
                            + (w if a < S - 1 else 0)]
                         * g[:, :, :, a * n + w - (w if a else 0):(a + 1) * n + w
                             + (w if a < S - 1 else 0)]).sum() for a in range(S))
            total.backward()
            errs[f"halo{S}.{w}.bwd"] = float((xs.grad - xr.grad[:, :, :, y0:y1]).abs().max())
        # statistics: group_stats and GroupNorm32 of this rank's slab
        ref_mean, ref_inv = group_stats(gn_x, 8)
        with torch.no_grad():
            ref_gn = norm(gn_x)
        with torch.no_grad(), pm.sp_active(ax):
            mean, inv = group_stats(gn_x[:, :, :, y0:y1], 8)
            gn = norm(gn_x[:, :, :, y0:y1])
        errs[f"stats{S}"] = max(float((mean - ref_mean).abs().max()),
                                float((inv - ref_inv).abs().max()))
        errs[f"gn{S}"] = float((gn - ref_gn[:, :, :, y0:y1]).abs().max())
        # the UNet: fp32 forward, gradients under use_checkpoint
        ly0, ly1 = pm.y_slab(ax, LATENT[2])
        xin = _nchw(_x(FWD_CFG))
        t = torch.tensor([7])
        model = _seeded(UNetModel(**FWD_CFG))
        with torch.no_grad(), pm.sp_active(ax):
            arrays[f"fwd{S}"] = model(xin[:, :, :, ly0:ly1].contiguous(),
                                      t).permute(0, 2, 3, 4, 1).numpy()
        remat = _seeded(UNetModel(use_checkpoint=True, **FWD_CFG)).train()
        cot = _nchw(inputs["cotangent"])[:, :, :, ly0:ly1]
        xs = xin[:, :, :, ly0:ly1].contiguous().requires_grad_()
        with pm.sp_active(ax):
            loss = pm.global_sum_sp((remat(xs, t) * cot).sum())
        loss.backward()
        arrays[f"gx{S}"] = xs.grad.permute(0, 2, 3, 4, 1).numpy()
        for k, p in remat.named_parameters():
            arrays[f"grad{S}.{k}"] = pm.all_reduce_sum_sp(p.grad, ax).numpy()
    # bf16 fuse_conv (K4b's plain version on halo-extended slabs), S = 2
    ly0, ly1 = pm.y_slab(m22, LATENT[2])
    fused = _seeded(UNetModel(fuse_conv=True, dtype=torch.bfloat16, **FUSE_CFG))
    with torch.no_grad(), pm.sp_active(m22.sp_axis):
        arrays["fuse2"] = fused(_nchw(_x(FUSE_CFG))[:, :, :, ly0:ly1].contiguous(),
                                torch.tensor([7])).permute(0, 2, 3, 4, 1).numpy()
    # make_synthesis_fn on (data 2, sp 2), the JAX key stream's noise
    model = _seeded(UNetModel(**TINY))
    vols = _volumes(4, 16, 3)
    cond = common.prepare_condition(vols, "t1c", device="cpu", mesh=m22)
    arrays["cond"] = cond.numpy()
    run = common.make_synthesis_fn(model, GaussianDiffusion.named("linear", 4, "sampled",
                                                                  mode="i2i"),
                                   crop_z=16, mesh=m22, device="cpu")
    arrays["synth.ddpm"] = run(cond, vols["t1n"], noise=inputs["ddpm.noise"],
                               step_noise=inputs["ddpm.step_noise"])
    run = common.make_synthesis_fn(model, GaussianDiffusion.named("linear", 4, "sampled",
                                                                  mode="i2i"),
                                   crop_z=16, mesh=m22, device="cpu", sampler="dpm++",
                                   sampler_steps=3)
    arrays["synth.dpm"] = run(cond, vols["t1n"], noise=inputs["dpm.noise"])
    out["step"] = _step(m22, inputs, arrays)
    out["errs"] = errs
    np.savez(os.path.join(work, f"four{r}.npz"), **arrays)
    print("RESULT " + json.dumps(out), flush=True)


def _step(mesh, inputs, arrays):
    """One train step of the tiny model on this rank's rows and slab of
    the global batch 2, with the JAX draws of t and the noise."""
    from fast_cwdm_tpu_torch.parallel import mesh as pm

    model = _seeded(UNetModel(**TINY))
    opt = train.make_optimizer(LR, eps=EPS)
    state = tstate.TrainState.create(model, opt)
    step = train.make_train_step(model, GaussianDiffusion.named("linear", 10, "sampled",
                                                                mode="i2i"),
                                 opt, contr="t1n", mode="i2i", mesh=mesh)
    batch = pm.shard_batch(mesh, _volumes(2, 8, 0), device="cpu")
    state, m = step(state, batch, t=torch.from_numpy(inputs["step.t"]).long(),
                    noise_img=torch.from_numpy(inputs["step.noise"]))
    for k, p in state.params.items():
        arrays[f"param.{k}"] = p.detach().numpy()
    comm = step.comm.drain_by_kind()
    return {"loss": float(m["loss"]), "mse_wav": m["mse_wav"].tolist(),
            "loss_per_sample": m["loss_per_sample"].tolist(),
            "comm": {k: [b, n] for k, (b, _, n) in comm.items()}}


def _two(work):
    """The 2-rank job (run in the child): a train step at (data 1, sp 2),
    then cli.train --spatial_mesh 2, two steps and a resume."""
    import sys

    from fast_cwdm_tpu_torch.parallel import mesh as pm
    from fast_cwdm_tpu_torch.training import checkpoints as ckpt

    inputs = np.load(os.path.join(work, "inputs.npz"))
    mesh = pm.make_mesh(sp=2)
    arrays = {}
    out = {"step": _step(mesh, inputs, arrays), "rank": mesh.process_rank}
    writes = []
    for name in ("save_checkpoint", "save_if_best"):
        def wrapped(*a, _f=getattr(ckpt, name), _n=name, **kw):
            writes.append(_n)
            return _f(*a, **kw)
        setattr(ckpt, name, wrapped)
    argv = json.loads(sys.argv[3])
    loop = cli_train.main(argv)
    out["train"] = {"losses": [r["loss"] for r in loop.step_log], "step": loop.state.step,
                    "halo_bytes": [r.get("halo_bytes_per_step") for r in loop.step_log],
                    "allreduce_bytes": [r.get("allreduce_bytes_per_step")
                                        for r in loop.step_log],
                    "writes": list(writes)}
    best = os.path.join(argv[-1].split("=", 1)[1], "brats_t1c_BEST_sampled_10.ckpt")
    resumed = cli_train.main([a for a in argv if not a.startswith("--lr_anneal_steps")]
                             + ["--lr_anneal_steps=3", f"--resume_checkpoint={best}"])
    out["resume"] = {"losses": [r["loss"] for r in resumed.step_log],
                     "steps": [r["step"] for r in resumed.step_log],
                     "resume_step": resumed.resume_step, "writes": writes[len(out["train"]
                                                                            ["writes"]):]}
    np.savez(os.path.join(work, f"two{mesh.process_rank}.npz"), **arrays)
    print("RESULT " + json.dumps(out), flush=True)


_CHILD = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from fast_cwdm_tpu_torch.parallel import mesh as pm
pm.setup_distributed("cpu")
import spatial_child
getattr(spatial_child, sys.argv[2])(sys.argv[1])
"""


def _child_module() -> str:
    """What the children need from this file, without JAX."""
    import inspect

    head = (
        "import json, os\nimport numpy as np, torch\n"
        "from fast_cwdm_tpu_torch.cli import train as cli_train\n"
        "from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion\n"
        "from fast_cwdm_tpu_torch.models.unet import UNetModel\n"
        "from fast_cwdm_tpu_torch.training import state as tstate, train\n"
        "from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict\n"
        f"MODALITIES = {MODALITIES!r}\nLR, EPS = {LR!r}, {EPS!r}\n"
        f"FWD_CFG = {FWD_CFG!r}\nFUSE_CFG = {FUSE_CFG!r}\nTINY = {TINY!r}\n"
        f"LATENT = {LATENT!r}\n"
    )
    body = "\n\n".join(inspect.getsource(f) for f in (_seeded, _x, _volumes, _nchw, _four,
                                                       _step, _two))
    return head + "\n\n" + body + "\n"


def _make_case(case_dir, seed, shape=(24, 24, 8)):
    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = os.path.basename(case_dir)
    for m in MODALITIES:
        vol = (rng.random(shape) * 900 + 100).astype(np.float32)
        nifti.save(nifti.Nifti1Image(vol, np.eye(4)),
                   os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))


def _jax_apply(cfg, x, dtype=None, **kw):
    jmodel = JUNet(dtype=dtype, **cfg, **kw)
    sd = _seeded(UNetModel(**cfg)).state_dict()
    params = torch_to_flax({k: v.numpy() for k, v in sd.items()}, jmodel)
    return np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                            jnp.asarray(np.array([7], np.int32))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank jobs, started once the JAX draws are written; the JAX
    references computed while they run."""
    work = tmp_path_factory.mktemp("spatial")
    shape = (4, 8, 8, 8, 8)
    key = jax.random.PRNGKey(5)
    key_init, key_loop = jax.random.split(key)
    inputs = {"ddpm.noise": np.array(jax.random.normal(key_init, shape, jnp.float32)),
              "ddpm.step_noise": np.stack([np.array(jax.random.normal(k, shape, jnp.float32))
                                           for k in jax.random.split(key_loop, 4)]),
              "dpm.noise": np.array(jax.random.normal(key, shape, jnp.float32))}
    step_key = jax.random.PRNGKey(11)
    key_t, key_noise, _ = jax.random.split(step_key, 3)
    inputs["step.t"] = np.array(jax.random.randint(key_t, (2,), 0, 10))
    inputs["step.noise"] = np.array(jax.random.normal(key_noise, (2, 8, 8, 8, 1), jnp.float32))
    inputs["cotangent"] = np.random.default_rng(9).standard_normal(
        (*LATENT, FWD_CFG["out_channels"])).astype(np.float32)
    np.savez(work / "inputs.npz", **inputs)
    (work / "spatial_child.py").write_text(_child_module())
    script = work / "child.py"
    script.write_text(_CHILD)
    for i in range(2):
        _make_case(str(work / "data" / f"0000{i}"), seed=i)
    argv = [f"--data_dir={work / 'data'}", "--lr=1e-4", "--batch_size=1", "--log_interval=1",
            "--save_interval=2", "--lr_anneal_steps=2", "--contr=t1c", "--cache_dataset=True",
            "--spatial_mesh=2", *TINY_FLAGS, f"--checkpoint_dir={work / 'ck'}"]
    env = dict(os.environ, OPENAI_LOGDIR=str(work / "log"))
    four = dryrun.start_ranks(4, [str(script), str(work), "_four"], env=env)
    two = dryrun.start_ranks(2, [str(script), str(work), "_two", json.dumps(argv)], env=env)

    ref = {"fwd": _jax_apply(FWD_CFG, _x(FWD_CFG))}
    ref["fuse"] = _jax_apply(FUSE_CFG, _x(FUSE_CFG), jnp.bfloat16, fuse_conv=True)
    ref["fuse32"] = _jax_apply(FUSE_CFG, _x(FUSE_CFG), fuse_conv=True)
    jmodel = JUNet(**TINY)
    params = torch_to_flax({k: v.numpy() for k, v in _seeded(UNetModel(**TINY)).state_dict()
                            .items()}, jmodel)
    vols = _volumes(4, 16, 3)
    jcond = jcommon.prepare_condition(vols, "t1c")
    ref["cond"] = np.asarray(jcond)
    jdiff = JDiffusion.named("linear", 4, "sampled", mode="i2i")
    ref["synth.ddpm"] = jcommon.make_synthesis_fn(jmodel, params, jdiff, crop_z=16)(
        jcond, vols["t1n"], key)
    ref["synth.dpm"] = jcommon.make_synthesis_fn(jmodel, params, jdiff, crop_z=16,
                                                 sampler="dpm++", sampler_steps=3)(
        jcond, vols["t1n"], key)
    # the port's one process on the same draws
    cond = common.prepare_condition(vols, "t1c", device="cpu")
    for k, kw, noise in (("ddpm", {}, dict(noise=inputs["ddpm.noise"],
                                          step_noise=inputs["ddpm.step_noise"])),
                         ("dpm", dict(sampler="dpm++", sampler_steps=3),
                          dict(noise=inputs["dpm.noise"]))):
        run = common.make_synthesis_fn(_seeded(UNetModel(**TINY)), GaussianDiffusion.named(
            "linear", 4, "sampled", mode="i2i"), crop_z=16, device="cpu", **kw)
        ref[f"one.{k}"] = run(cond, vols["t1n"], **noise)
    tx = jmake_optimizer(LR, eps=EPS)
    jstep = jmake_train_step(jmodel, JDiffusion.named("linear", 10, "sampled", mode="i2i"), tx,
                             contr="t1n", mode="i2i")
    _, jm = jstep(JTrainState.create(params, tx), jax.tree.map(jnp.asarray, _volumes(2, 8, 0)),
                  step_key)
    np.testing.assert_array_equal(np.asarray(jm["t"]), inputs["step.t"])
    ref["step"] = {k: np.asarray(v) for k, v in jm.items()}
    # the port's one process: the same step, the unsharded gradients
    model = _seeded(UNetModel(**TINY))
    opt = train.make_optimizer(LR, eps=EPS)
    step = train.make_train_step(model, GaussianDiffusion.named("linear", 10, "sampled",
                                                                mode="i2i"),
                                 opt, contr="t1n", mode="i2i")
    state, _ = step(tstate.TrainState.create(model, opt),
                    {k: torch.from_numpy(v) for k, v in _volumes(2, 8, 0).items()},
                    t=torch.from_numpy(inputs["step.t"]).long(),
                    noise_img=torch.from_numpy(inputs["step.noise"]))
    ref["params"] = {k: p.detach().numpy() for k, p in state.params.items()}
    remat = _seeded(UNetModel(use_checkpoint=True, **FWD_CFG)).train()
    xin = _nchw(_x(FWD_CFG)).requires_grad_()
    (remat(xin, torch.tensor([7])) * _nchw(inputs["cotangent"])).sum().backward()
    ref["gx"] = xin.grad.permute(0, 2, 3, 4, 1).numpy()
    ref["grads"] = {k: p.grad.numpy() for k, p in remat.named_parameters()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENAI_LOGDIR", str(work / "log1"))
        one = cli_train.main([a for a in argv if a != "--spatial_mesh=2"][:-1]
                             + [f"--checkpoint_dir={work / 'ck1'}"])
    ref["one_losses"] = [r["loss"] for r in one.step_log]

    recs = {"four": dryrun.results(dryrun.wait_ranks(four, TIMEOUT)),
            "two": dryrun.results(dryrun.wait_ranks(two, TIMEOUT))}
    arrays = {"four": [dict(np.load(work / f"four{r}.npz")) for r in range(4)],
              "two": [dict(np.load(work / f"two{r}.npz")) for r in range(2)]}
    return dict(recs=recs, arrays=arrays, ref=ref, work=work)


def test_mesh_indices_groups_and_slabs(runs):
    """World 4 as (data 2, sp 2): rank r is data index r // 2 and sp index
    r % 2; the data group gathers one rank per data index, the sp group
    sums consecutive ranks, the flag is agreed over the world; (data 1,
    sp 4) puts every rank in one sp group. Rows by data index, Y slab by sp
    index."""
    for r, rec in enumerate(runs["recs"]["four"]):
        m = rec["mesh"]
        assert m["shape"] == {"data": 2, "sp": 2} and m["process_rank"] == r
        assert (m["rank"], m["sp_rank"]) == (r // 2, r % 2)
        assert m["data_gather"] == [float(r % 2), float(2 + r % 2)]
        assert m["sp_sum"] == float(2 * (r // 2) * 2 + 1)
        assert m["sp_gather"] == [0.0, 1.0, 2.0, 3.0] and m["any"] == [True, False]
        assert m["shape14"] == {"data": 1, "sp": 4} and m["sp_rank14"] == r
        assert m["rows"] == [2 * (r // 2), 2 * (r // 2) + 2] and m["slab"] == [4 * (r % 2),
                                                                               4 * (r % 2) + 4]
        g = np.arange(48).reshape(2, 3, 8)
        assert m["shard"] == g[r // 2: r // 2 + 1, :, 4 * (r % 2): 4 * (r % 2) + 4].tolist()


@pytest.mark.parametrize("S", [2, 4])
def test_halo_exchange_forward_and_adjoint(runs, S):
    """halo_exchange equals slicing the unsharded tensor (the neighbours'
    planes on interior sides only), halo_pad slicing its zero-padded
    version, and the backward the unsharded gradient of the windows."""
    for rec in runs["recs"]["four"]:
        e = rec["errs"]
        for w in (1, 2) if S == 2 else (1,):
            assert e[f"halo{S}.{w}.shape"]
            assert e[f"halo{S}.{w}.fwd"] == 0.0 and e[f"halo{S}.{w}.pad"] == 0.0
            assert e[f"halo{S}.{w}.bwd"] <= 1e-6


@pytest.mark.parametrize("S", [2, 4])
def test_group_statistics_are_the_volumes(runs, S):
    """group_stats and GroupNorm32 of a slab under sp: the unsharded
    result's slab within 1e-6."""
    for rec in runs["recs"]["four"]:
        assert rec["errs"][f"stats{S}"] <= 1e-6 and rec["errs"][f"gn{S}"] <= 1e-6


@pytest.mark.parametrize("S", [2, 4])
def test_unet_forward_matches_jax(runs, S):
    """fp32: every rank's output slab against the JAX UNetModel's whole
    output, 5e-5 (at S = 4 level 3 runs gathered, the decoder re-shards)."""
    ref = runs["ref"]["fwd"]
    n = LATENT[2] // S
    for r, arr in enumerate(runs["arrays"]["four"]):
        k = (r % 2 if S == 2 else r) * n
        np.testing.assert_allclose(arr[f"fwd{S}"], ref[:, :, k:k + n], atol=5e-5)


@pytest.mark.parametrize("S", [2, 4])
def test_use_checkpoint_gradients_match_one_process(runs, S):
    """use_checkpoint with a backward (the recomputation issues the
    blocks' collectives again): the input's gradient slab and the
    parameters' gradients summed over sp against the port's unsharded
    model, relative to the largest gradient, 1e-5."""
    ref = runs["ref"]
    n = LATENT[2] // S
    for r, arr in enumerate(runs["arrays"]["four"]):
        k = (r % 2 if S == 2 else r) * n
        scale = np.abs(ref["gx"]).max()
        assert np.abs(arr[f"gx{S}"] - ref["gx"][:, :, k:k + n]).max() <= 1e-5 * scale
        for name, g in ref["grads"].items():
            assert np.abs(arr[f"grad{S}.{name}"] - g).max() <= 1e-5 * max(np.abs(g).max(),
                                                                          1e-3), name


def test_fuse_conv_bf16_matches_jax(runs):
    """bf16 fuse_conv at S = 2 (K4b's plain version on halo-extended
    slabs): within BF16_FACTOR times what bf16 costs the JAX model."""
    ref, ref32 = runs["ref"]["fuse"], runs["ref"]["fuse32"]
    bound = BF16_FACTOR * np.max(np.abs(ref - ref32))
    n = LATENT[2] // 2
    for r, arr in enumerate(runs["arrays"]["four"]):
        k = (r % 2) * n
        assert np.max(np.abs(arr["fuse2"] - ref[:, :, k:k + n])) <= bound


# (against the port's one process, against JAX's) of each sampler: ddpm
# within JAX's own sharded-vs-unsharded 1e-5 (tests/test_parallel.py:279);
# dpm++ 3 steps amplifies float32 rounding to 1.4e-5 between the port's and
# JAX's unsharded chains on these draws already, so it is held at 2e-5 to
# the port's one process and at the port's chain tolerance, 1e-4
# (tests/test_torch_synthesis.py), to JAX
SYNTH_ATOL = {"ddpm": (1e-5, 1e-5), "dpm": (2e-5, 1e-4)}


def test_sharded_synthesis_matches_jax_unsharded(runs):
    """make_synthesis_fn on (data 2, sp 2), ddpm 4 steps and dpm++ 3: the
    condition's DWT on slabs against JAX's (1e-5); the images against the
    port's unsharded run on the same draws and JAX's unsharded run with the
    same key stream (``SYNTH_ATOL``); every rank returns the whole batch."""
    ref = runs["ref"]
    for arr in runs["arrays"]["four"]:
        np.testing.assert_allclose(arr["cond"], ref["cond"], atol=1e-5)
        for k, (atol_one, atol_jax) in SYNTH_ATOL.items():
            ours = arr[f"synth.{k}"]
            assert ours.shape == ref[f"synth.{k}"].shape == (4, 16, 16, 16)
            assert ref[f"synth.{k}"].max() > 0
            np.testing.assert_allclose(ours, ref[f"one.{k}"], atol=atol_one)
            np.testing.assert_allclose(ours, ref[f"synth.{k}"], atol=atol_jax)


@pytest.mark.parametrize("job", ["four", "two"])
def test_sharded_step_matches_jax_and_one_process(runs, job):
    """A train step at (data 2, sp 2) and (data 1, sp 2): the loss (rtol
    2e-5) and mse_wav (rtol 2e-4) of JAX's unsharded step, the rows'
    losses; the parameters after one AdamW step the same bits on every
    rank and within 5e-3·lr of the port's one process; one all-reduce of
    the gradients and the sp collectives in the step's log."""
    ref = runs["ref"]
    jm = ref["step"]
    n_params = sum(v.size for v in ref["params"].values())
    for r, (rec, arr) in enumerate(zip(runs["recs"][job], runs["arrays"][job])):
        st = rec["step"]
        np.testing.assert_allclose(st["loss"], float(jm["loss"]), rtol=2e-5)
        np.testing.assert_allclose(st["mse_wav"], jm["mse_wav"], rtol=2e-4, atol=1e-6)
        rows = slice(r // 2, r // 2 + 1) if job == "four" else slice(0, 2)
        np.testing.assert_allclose(st["loss_per_sample"], jm["loss_per_sample"][rows],
                                   rtol=2e-5)
        for k, v in ref["params"].items():
            assert np.abs(arr[f"param.{k}"] - v).max() <= 5e-3 * LR, k
            assert np.array_equal(arr[f"param.{k}"], runs["arrays"][job][0][f"param.{k}"]), k
        assert st["comm"]["allreduce"] == [4 * (n_params + 1 + 8), 1]
        assert st["comm"]["halo"][0] > 0 and st["comm"]["sp_reduce"][1] > 0


def test_cli_train_spatial_mesh_two_ranks(runs):
    """cli.train --spatial_mesh 2 as two ranks: two steps with the losses
    of one process on the same batches (2e-5), halo bytes logged, files
    written by rank 0 only; resumed from the BEST, one step more (step 3)
    on both ranks."""
    recs = runs["recs"]["two"]
    for rec in recs:
        tr = rec["train"]
        assert tr["step"] == 2 and len(tr["losses"]) == 2
        np.testing.assert_allclose(tr["losses"], runs["ref"]["one_losses"], atol=2e-5)
        assert all(b > 0 for b in tr["halo_bytes"]) and all(b > 0 for b in tr["allreduce_bytes"])
        assert rec["resume"]["resume_step"] == 2 and rec["resume"]["steps"] == [3]
        assert np.isfinite(rec["resume"]["losses"]).all()
    assert recs[0]["train"]["losses"] == recs[1]["train"]["losses"]
    assert recs[0]["resume"]["losses"] == recs[1]["resume"]["losses"]
    assert recs[0]["train"]["writes"] and recs[0]["resume"]["writes"]
    assert not recs[1]["train"]["writes"] and not recs[1]["resume"]["writes"]
    files = set(os.listdir(runs["work"] / "ck"))
    assert {"best_losses.txt", "brats_t1c_BEST_sampled_10.ckpt", "opt_best_t1c.ckpt"} <= files
    assert os.path.exists(runs["work"] / "log" / "progress.csv")


def test_wavelets_under_sp_are_haar_on_even_slabs():
    """Under an sp axis (no collective runs here): Haar on a slab of even
    length at an even offset is local; an odd slab fails the check, for a
    longer filter too (whose halo exchange tests/test_torch_tensor.py's
    rank job holds to JAX)."""
    axis = pmesh.SpAxis(None, 2, 1)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 4, 4, 4, 1), dtype=np.float32))
    with pmesh.sp_active(axis):
        np.testing.assert_allclose(wv.idwt3_flat(wv.dwt3_flat(x)).numpy(), x.numpy(), atol=1e-6)
        with pytest.raises(ValueError, match="even offset and length"):
            wv.dwt3_flat(x[:, :, :3])
        with pytest.raises(ValueError, match="offset 3"):
            wv.dwt3(x[:, :, :3])
        for fn in (lambda: wv.dwt3_flat(x[:, :, :3], "db2"),
                   lambda: wv.dwt3(x[:, :, :3], "db2")):
            with pytest.raises(ValueError, match="even offset and length"):
                fn()
    assert pmesh.current_sp() is None


def test_dryrun_multichip_four_ranks_sp_2():
    """dryrun_multichip(4, sp=2): the mesh the JAX dry run reports, every
    rank's loss, parameters and synthesis the same."""
    rec = dryrun.dryrun_multichip(4, timeout=TIMEOUT, sp=2)
    assert rec["mesh"] == {"data": 2, "sp": 2} and rec["step"] == 1
    assert rec["synthesis_shape"] == [2, 16, 16, 16] and np.isfinite(rec["loss"])
