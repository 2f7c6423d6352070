"""The port's tp axis (output-channel-sharded parameters, ``parallel/mesh.py``)
on the CPU: ``gloo`` ranks in child processes against the JAX package
unsharded and the port's one process.

- one 2-rank job at ``tp=2``: the mesh, the fp32 forward, the bf16
  ``fuse_conv`` forward (K4b's plain version on channel slices), the
  gradients under ``use_checkpoint`` (and the same gradients with the tp
  gather's backward replaced by a reduce-scatter, which this file shows
  the check refuses), a train step, ``make_synthesis_fn`` (ddpm and dpm++)
  and ``cli.train --tensor_mesh 2`` (two steps, a BEST, a resume);
- one 4-rank job at ``(data 1, sp 2, tp 2)``: the mesh's indices and
  groups, the fp32 forward on slabs, a train step, and db2's DWT and IDWT
  on sp slabs (each rank's halo from its neighbours);
- one process: ``param_spec`` against JAX's on every leaf, the sharding
  rule on single layers, the production config's counts;
- ``dryrun_multichip(8)`` on JAX's 2×2×2 mesh.

The children import no JAX; the JAX side runs here while they run.
Tolerances: forwards 5e-5 (fp32) and ``tests/test_torch_unet.py``'s bf16
bound; losses rtol 2e-5 (``tests/test_parallel.py:92``); parameters after
one AdamW step within 5e-3·lr of JAX's; synthesis 1e-4 against JAX
(``tests/test_torch_synthesis.py``); gradients 1e-5 of their scale.
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
from fast_cwdm_tpu.parallel import make_mesh as jmake_mesh
from fast_cwdm_tpu.parallel import param_spec as jparam_spec
from fast_cwdm_tpu.training import TrainState as JTrainState
from fast_cwdm_tpu.training import bridge
from fast_cwdm_tpu.training import make_optimizer as jmake_optimizer
from fast_cwdm_tpu.training import make_train_step as jmake_train_step
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.cli import train as cli_train
from fast_cwdm_tpu_torch.data import nifti
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
from fast_cwdm_tpu_torch.models.nn import Conv3d
from fast_cwdm_tpu_torch.models.unet import Embedding, Linear, UNetModel
from fast_cwdm_tpu_torch.parallel import dryrun
from fast_cwdm_tpu_torch.parallel import mesh as pmesh
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training import train
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

TIMEOUT = 240
MODALITIES = ("t1n", "t1c", "t2w", "t2f")
LR, EPS = 1e-4, 1e-3
# latent Y 16: slabs of 8 at sp 2; every width even, so every weight of
# two or more axes is sharded at tp 2
FWD_CFG = dict(image_size=8, in_channels=16, model_channels=16, out_channels=8,
               num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2, 2), dims=3,
               num_groups=8, resblock_updown=True, bottleneck_attention=False,
               resample_2d=False)
FUSE_CFG = dict(FWD_CFG, in_channels=32, model_channels=32)
LATENT = (1, 8, 16, 8)  # (B, X, Y, Z) of the forward tests' input
# tests/test_parallel.py's tiny model and sizes (synthesis: batch 2 of 16³,
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


def _step(mesh, inputs, arrays):
    """One train step of the tiny model, sharded over tp, on this rank's
    rows and slab of the global batch 2, with the JAX draws of t and the
    noise; this rank's parameters after it."""
    from fast_cwdm_tpu_torch.parallel import mesh as pm
    from fast_cwdm_tpu_torch.training import state as tstate

    model = pm.shard_params(mesh, _seeded(UNetModel(**TINY)))
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
        arrays[f"mu.{k}"] = state.opt_state["mu"][k].numpy()
    comm = step.comm.drain_by_kind()
    return {"loss": float(m["loss"]), "mse_wav": m["mse_wav"].tolist(),
            "grad_max": float(m["grad_max"]), "param_max": float(m["param_max"]),
            "sharded": sorted(pm.sharded_params(model)),
            "comm": {k: [b, n] for k, (b, _, n) in comm.items()}}


def _grads(mesh, inputs, arrays, tag):
    """use_checkpoint gradients of the fp32 forward, sharded over tp: this
    rank's gradient of every parameter and of the input."""
    from fast_cwdm_tpu_torch.parallel import mesh as pm

    remat = pm.shard_params(mesh, _seeded(UNetModel(use_checkpoint=True, **FWD_CFG)).train())
    xin = _nchw(_x(FWD_CFG)).requires_grad_()
    with pm.tp_active(mesh.tp_axis):
        (remat(xin, torch.tensor([7])) * _nchw(inputs["cotangent"])).sum().backward()
    arrays[f"{tag}gx"] = xin.grad.permute(0, 2, 3, 4, 1).numpy()
    for k, p in remat.named_parameters():
        arrays[f"{tag}grad.{k}"] = p.grad.numpy()


def _two(work):
    """The 2-rank job at tp 2 (run in the child)."""
    import gc
    import sys

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.parallel import mesh as pm
    from fast_cwdm_tpu_torch.training import checkpoints as ckpt

    inputs = np.load(os.path.join(work, "inputs.npz"))
    mesh = pm.make_mesh(tp=2)
    r = mesh.process_rank
    one = torch.tensor([float(r)])
    out = {"mesh": dict(shape=mesh.shape, rank=mesh.rank, tp_rank=mesh.tp_rank,
                        sp=mesh.sp_axis is None, group=mesh.group is None,
                        replica=mesh.replica is None,
                        tp_gather=pm.all_gather_tp(one, 0, mesh.tp_axis).tolist())}
    arrays = {}
    model = pm.shard_params(mesh, _seeded(UNetModel(**FWD_CFG)))
    with torch.no_grad(), pm.tp_active(mesh.tp_axis):
        arrays["fwd"] = model(_nchw(_x(FWD_CFG)), torch.tensor([7])).permute(
            0, 2, 3, 4, 1).numpy()
        fused = pm.shard_params(mesh, _seeded(UNetModel(fuse_conv=True, dtype=torch.bfloat16,
                                                        **FUSE_CFG)))
        arrays["fuse"] = fused(_nchw(_x(FUSE_CFG)), torch.tensor([7])).permute(
            0, 2, 3, 4, 1).numpy()
    comm = mesh.tp_axis.log.drain_by_kind()
    out["gather"] = {k: [b, n] for k, (b, _, n) in comm.items()}
    _grads(mesh, inputs, arrays, "")
    # the same gradients with the gather's backward a reduce-scatter (the
    # sum of the ranks' gradients, this rank's slice): tp times the truth
    real = pm._TpGather.backward

    def reduce_scatter(ctx, g):
        g = pm._all_reduce(ctx.axis.group, g.contiguous())
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None

    pm._TpGather.backward = staticmethod(reduce_scatter)
    try:
        _grads(mesh, inputs, arrays, "rs.")
    finally:
        pm._TpGather.backward = real
    out["step"] = _step(mesh, inputs, arrays)
    # make_synthesis_fn over the tp group, the JAX key stream's noise
    vols = _volumes(2, 16, 3)
    cond = common.prepare_condition(vols, "t1c", device="cpu", mesh=mesh)
    for k, kw, noise in (("ddpm", {}, dict(noise=inputs["ddpm.noise"],
                                          step_noise=inputs["ddpm.step_noise"])),
                         ("dpm", dict(sampler="dpm++", sampler_steps=3),
                          dict(noise=inputs["dpm.noise"]))):
        run = common.make_synthesis_fn(_seeded(UNetModel(**TINY)), GaussianDiffusion.named(
            "linear", 4, "sampled", mode="i2i"), crop_z=16, mesh=mesh, device="cpu", **kw)
        arrays[f"synth.{k}"] = run(cond, vols["t1n"], **noise)
    out["chain"] = run.chain is None
    writes = []
    for name in ("save_checkpoint", "save_if_best"):
        def wrapped(*a, _f=getattr(ckpt, name), _n=name, **kw):
            writes.append(_n)
            return _f(*a, **kw)
        setattr(ckpt, name, wrapped)
    argv = json.loads(sys.argv[3])
    loop = cli_train.main(argv)
    st = loop.state
    for k in st.params:
        arrays[f"state.params.{k}"] = st.params[k].detach().numpy()
        arrays[f"state.ema.{k}"] = st.ema_params[0][k].numpy()
        for m in ("mu", "nu"):
            arrays[f"state.{m}.{k}"] = st.opt_state[m][k].numpy()
    out["train"] = {"losses": [x["loss"] for x in loop.step_log], "step": st.step,
                    "count": st.opt_state["count"], "writes": list(writes),
                    "tp_gather_bytes": [x.get("tp_gather_bytes_per_step") for x in loop.step_log],
                    "allreduce_bytes": [x.get("allreduce_bytes_per_step")
                                        for x in loop.step_log]}
    best = os.path.join(argv[-1].split("=", 1)[1], "brats_t1c_BEST_sampled_10.ckpt")
    del loop, st
    # the resumed run writes elsewhere: the BEST of step 2 stays for the
    # byte comparison
    resumed = cli_train.main([a for a in argv if not a.startswith("--lr_anneal_steps")][:-1]
                             + ["--lr_anneal_steps=3", f"--resume_checkpoint={best}",
                                argv[-1] + "_resumed"])
    out["resume"] = {"losses": [x["loss"] for x in resumed.step_log],
                     "steps": [x["step"] for x in resumed.step_log],
                     "resume_step": resumed.resume_step}
    del resumed
    np.savez(os.path.join(work, f"two{r}.npz"), **arrays)
    print("RESULT " + json.dumps(out), flush=True)
    gc.collect()


def _four(work):
    """The 4-rank job at (data 1, sp 2, tp 2) (run in the child)."""
    from fast_cwdm_tpu_torch.parallel import mesh as pm

    inputs = np.load(os.path.join(work, "inputs.npz"))
    mesh = pm.make_mesh(sp=2, tp=2)
    r = mesh.process_rank
    one = torch.tensor([float(r)])
    out = {"mesh": dict(
        shape=mesh.shape, rank=mesh.rank, sp_rank=mesh.sp_rank, tp_rank=mesh.tp_rank,
        tp_gather=pm.all_gather_tp(one, 0, mesh.tp_axis).tolist(),
        sp_sum=float(pm.all_reduce_sum_sp(one, mesh.sp_axis)),
        replica_sum=float(pm._all_reduce(mesh.replica, one)), group=mesh.group is None)}
    arrays = {}
    y0, y1 = pm.y_slab(mesh, LATENT[2])
    model = pm.shard_params(mesh, _seeded(UNetModel(**FWD_CFG)))
    with torch.no_grad(), pm.sp_active(mesh.sp_axis), pm.tp_active(mesh.tp_axis):
        arrays["fwd"] = model(_nchw(_x(FWD_CFG))[:, :, :, y0:y1].contiguous(),
                              torch.tensor([7])).permute(0, 2, 3, 4, 1).numpy()
    out["step"] = _step(mesh, inputs, arrays)
    # db2 on this rank's Y slab of a volume (axis 2) and of its latent
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    vol, lat = torch.from_numpy(inputs["db2.vol"]), torch.from_numpy(inputs["db2.lat"])
    v0, v1 = pm.y_slab(mesh, vol.shape[2])
    c0, c1 = pm.y_slab(mesh, lat.shape[2])
    with pm.sp_active(mesh.sp_axis):
        arrays["db2.dwt"] = wv.dwt_normalized(vol[:, :, v0:v1].contiguous(), "db2").numpy()
        arrays["db2.idwt"] = wv.idwt_normalized(lat[:, :, c0:c1].contiguous(), 1,
                                                "db2").numpy()
    np.savez(os.path.join(work, f"four{r}.npz"), **arrays)
    print("RESULT " + json.dumps(out), flush=True)


_CHILD = r"""
import gc, os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from fast_cwdm_tpu_torch.parallel import mesh as pm
pm.setup_distributed("cpu")
import tensor_child
getattr(tensor_child, sys.argv[2])(sys.argv[1])
gc.collect()
torch.distributed.destroy_process_group()
"""


def _child_module() -> str:
    """What the children need from this file, without JAX."""
    import inspect

    head = (
        "import json, os\nimport numpy as np, torch\n"
        "from fast_cwdm_tpu_torch.cli import train as cli_train\n"
        "from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion\n"
        "from fast_cwdm_tpu_torch.models.unet import UNetModel\n"
        "from fast_cwdm_tpu_torch.training import train\n"
        "from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict\n"
        f"MODALITIES = {MODALITIES!r}\nLR, EPS = {LR!r}, {EPS!r}\n"
        f"FWD_CFG = {FWD_CFG!r}\nFUSE_CFG = {FUSE_CFG!r}\nTINY = {TINY!r}\n"
        f"LATENT = {LATENT!r}\n"
    )
    body = "\n\n".join(inspect.getsource(f) for f in (_seeded, _x, _volumes, _nchw, _step,
                                                       _grads, _two, _four))
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
    params = bridge.torch_to_flax({k: v.numpy() for k, v in sd.items()}, jmodel)
    return np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                            jnp.asarray(np.array([7], np.int32))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank jobs, started once the JAX draws are written; the JAX
    references and the port's one process computed while they run."""
    work = tmp_path_factory.mktemp("tensor")
    shape = (2, 8, 8, 8, 8)
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
    inputs["db2.vol"] = np.random.default_rng(12).random((1, 16, 16, 16, 1), np.float32)
    inputs["db2.lat"] = np.random.default_rng(13).standard_normal(
        (1, 8, 8, 8, 8)).astype(np.float32)
    np.savez(work / "inputs.npz", **inputs)
    (work / "tensor_child.py").write_text(_child_module())
    script = work / "child.py"
    script.write_text(_CHILD)
    for i in range(2):
        _make_case(str(work / "data" / f"0000{i}"), seed=i)
    argv = [f"--data_dir={work / 'data'}", "--lr=1e-4", "--batch_size=1", "--log_interval=1",
            "--save_interval=2", "--lr_anneal_steps=2", "--contr=t1c", "--cache_dataset=True",
            "--ema_rate=0.9", "--tensor_mesh=2", *TINY_FLAGS, f"--checkpoint_dir={work / 'ck'}"]
    env = dict(os.environ, OPENAI_LOGDIR=str(work / "log"))
    two = dryrun.start_ranks(2, [str(script), str(work), "_two", json.dumps(argv)], env=env)
    four = dryrun.start_ranks(4, [str(script), str(work), "_four"], env=env)

    ref = {"fwd": _jax_apply(FWD_CFG, _x(FWD_CFG))}
    from fast_cwdm_tpu.ops import wavelet as jwv
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    ref["db2.dwt"] = np.asarray(jwv.dwt_normalized(jnp.asarray(inputs["db2.vol"]), "db2"))
    ref["db2.idwt"] = np.asarray(jwv.idwt_normalized(jnp.asarray(inputs["db2.lat"]), 1, "db2"))
    ref["db2.one.dwt"] = wv.dwt_normalized(torch.from_numpy(inputs["db2.vol"]), "db2").numpy()
    ref["db2.one.idwt"] = wv.idwt_normalized(torch.from_numpy(inputs["db2.lat"]), 1,
                                             "db2").numpy()
    ref["fuse"] = _jax_apply(FUSE_CFG, _x(FUSE_CFG), jnp.bfloat16, fuse_conv=True)
    ref["fuse32"] = _jax_apply(FUSE_CFG, _x(FUSE_CFG), fuse_conv=True)
    jmodel = JUNet(**TINY)
    params = bridge.torch_to_flax({k: v.numpy() for k, v in _seeded(UNetModel(**TINY))
                                   .state_dict().items()}, jmodel)
    vols = _volumes(2, 16, 3)
    jcond = jcommon.prepare_condition(vols, "t1c")
    jdiff = JDiffusion.named("linear", 4, "sampled", mode="i2i")
    ref["synth.ddpm"] = jcommon.make_synthesis_fn(jmodel, params, jdiff, crop_z=16)(
        jcond, vols["t1n"], key)
    ref["synth.dpm"] = jcommon.make_synthesis_fn(jmodel, params, jdiff, crop_z=16,
                                                 sampler="dpm++", sampler_steps=3)(
        jcond, vols["t1n"], key)
    tx = jmake_optimizer(LR, eps=EPS)
    jstep = jmake_train_step(jmodel, JDiffusion.named("linear", 10, "sampled", mode="i2i"), tx,
                             contr="t1n", mode="i2i")
    jstate, jm = jstep(JTrainState.create(params, tx),
                       jax.tree.map(jnp.asarray, _volumes(2, 8, 0)), step_key)
    np.testing.assert_array_equal(np.asarray(jm["t"]), inputs["step.t"])
    ref["step"] = {k: np.asarray(v) for k, v in jm.items()}
    ref["params"] = bridge.flax_to_torch(jax.tree.map(np.asarray, jstate.params), jmodel)
    ref["mu"] = bridge.flax_to_torch(jax.tree.map(np.asarray, jstate.opt_state[0].mu), jmodel)
    # the port's one process: use_checkpoint gradients, cli.train and its
    # resume on the same batches
    remat = _seeded(UNetModel(use_checkpoint=True, **FWD_CFG)).train()
    xin = _nchw(_x(FWD_CFG)).requires_grad_()
    (remat(xin, torch.tensor([7])) * _nchw(inputs["cotangent"])).sum().backward()
    ref["gx"] = xin.grad.permute(0, 2, 3, 4, 1).numpy()
    ref["grads"] = {k: p.grad.numpy() for k, p in remat.named_parameters()}
    one_argv = [a for a in argv if a != "--tensor_mesh=2"][:-1] + [
        f"--checkpoint_dir={work / 'ck1'}"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENAI_LOGDIR", str(work / "log1"))
        one = cli_train.main(one_argv)
        ref["one_losses"] = [r["loss"] for r in one.step_log]
        best = str(work / "ck" / "brats_t1c_BEST_sampled_10.ckpt")
        recs = {"two": dryrun.results(dryrun.wait_ranks(two, TIMEOUT))}
        # one process resumed from the BEST the tp ranks wrote
        resumed = cli_train.main(
            [a for a in one_argv if not a.startswith("--lr_anneal_steps")][:-1]
            + ["--lr_anneal_steps=3", f"--resume_checkpoint={best}",
               f"--checkpoint_dir={work / 'ck2'}"])
        ref["resume_losses"] = [r["loss"] for r in resumed.step_log]
        ref["model"] = one.model
    recs["four"] = dryrun.results(dryrun.wait_ranks(four, TIMEOUT))
    arrays = {"two": [dict(np.load(work / f"two{r}.npz")) for r in range(2)],
              "four": [dict(np.load(work / f"four{r}.npz")) for r in range(4)]}
    return dict(recs=recs, arrays=arrays, ref=ref, work=work)


# -- one process ---------------------------------------------------------------

def _tp_mesh(tp=2, rank=0):
    """A tp mesh's description without a process group (param_spec and
    shard_params read only its tp size and rank)."""
    return pmesh.DataMesh({"data": 1, "sp": 1, "tp": tp}, None, 0,
                          tp_axis=pmesh.TpAxis(None, tp, rank))


@pytest.mark.parametrize("cfg", [TINY, dict(image_size=16, in_channels=32, model_channels=32,
                                            out_channels=8, num_res_blocks=2,
                                            attention_resolutions=(), channel_mult=(1, 2),
                                            dims=3, num_groups=8, resblock_updown=True,
                                            bottleneck_attention=False, resample_2d=False),
                                 dict(TINY, model_channels=32, channel_mult=(1, 2, 2, 4, 4),
                                      num_res_blocks=2)],
                         ids=["tiny", "dryrun", "production_shaped"])
def test_param_spec_agrees_with_jax_on_every_leaf(cfg):
    """For every parameter, through the bridge's names: sharded by the
    port exactly where JAX's ``param_spec`` shards the flax leaf, and on
    the torch axis that is the flax leaf's last."""
    jmodel = JUNet(**cfg)
    model = UNetModel(**cfg)
    params = bridge.torch_to_flax({k: v.detach().numpy() for k, v in model.state_dict().items()},
                                  jmodel)
    jmesh = jmake_mesh(data=1, sp=1, tp=2)
    mesh = _tp_mesh()
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    names = dict(model.named_parameters())
    checked = 0
    for tfull, ffull, kind, alias in bridge._leaf_entries(jmodel):
        for tname in ("weight", "bias"):
            tk = f"{tfull}.{tname}"
            if alias or tk not in names:
                continue
            fname = bridge._t2f_leaf(kind, tname, names[tk].detach().numpy(), 3)[0]
            leaf = flat[f"{ffull}/{fname}"]
            jsharded = jparam_spec(leaf, jmesh) != jax.sharding.PartitionSpec()
            axis = pmesh.param_spec(model, tk, mesh)
            assert jsharded == (axis is not None), tk
            if axis is not None:
                assert names[tk].shape[axis] == leaf.shape[-1], tk
            checked += 1
    assert checked == len(names)


def test_tp_sharding_rule_on_single_layers():
    """The counterpart of tests/test_parallel.py::TestTensorParallel: a
    conv kernel sharded on its output channels, its bias replicated, a
    (4, 7) flax leaf (a Linear of 7 outputs) replicated, an nn.Embedding
    sharded on dim 1 (flax Embed's features); shard_params keeps rank 1's
    slices; the two-axis mesh keeps its shape."""
    model = torch.nn.ModuleDict({"conv": Conv3d(8, 16, 3), "dense": Linear(4, 7),
                                 "emb": Embedding(5, 6)})
    mesh = _tp_mesh(rank=1)
    spec = {k: pmesh.param_spec(model, k, mesh) for k, _ in model.named_parameters()}
    assert spec == {"conv.weight": 0, "conv.bias": None, "dense.weight": None,
                    "dense.bias": None, "emb.weight": 1}
    full = {k: v.detach().clone() for k, v in model.named_parameters()}
    pmesh.shard_params(mesh, model)
    got = dict(model.named_parameters())
    assert torch.equal(got["conv.weight"], full["conv.weight"][8:])
    assert torch.equal(got["emb.weight"], full["emb.weight"][:, 3:])
    assert torch.equal(got["conv.bias"], full["conv.bias"])
    assert torch.equal(got["dense.weight"], full["dense.weight"])
    assert pmesh.sharded_params(model) == {"conv.weight": 0, "emb.weight": 1}
    assert pmesh.shard_tensors(mesh, model, full)["emb.weight"].shape == (5, 3)
    # a slice without an active tp axis refuses to run
    with pytest.raises(RuntimeError, match="tp_active"):
        model["emb"](torch.tensor([1]))
    assert pmesh.make_mesh().shape == {"data": 1, "sp": 1}


@pytest.mark.parametrize("groups,tp", [(1, 2), (2, 2), (7, 2), (2, 4)])
def test_grouped_conv_slices_are_the_unsharded_conv_slices(groups, tp):
    """A grouped conv's tp slice of output channels (no communication:
    ``tp_grouped_conv``): each rank's output is its slice of the unsharded
    conv's, whether the slice covers whole groups (2 over 2), a part of one
    (2 over 4) or cuts through groups (7 over 2, the WavUNet's SkipConv)."""
    import functools

    import torch.nn.functional as F

    from fast_cwdm_tpu_torch.models.nn import tp_grouped_conv

    g = torch.Generator().manual_seed(groups * 10 + tp)
    x = torch.randn(1, 2 * groups, 4, 6, 4, generator=g)
    w = torch.randn(4 * groups, 2, 3, 3, 3, generator=g)
    conv = functools.partial(F.conv3d, stride=1, padding=1, dilation=1)
    whole = conv(x, w, groups=groups)
    n = w.shape[0] // tp
    for r in range(tp):
        got = tp_grouped_conv(conv, x, w[r * n:(r + 1) * n], groups, pmesh.TpAxis(None, tp, r))
        torch.testing.assert_close(got, whole[:, r * n:(r + 1) * n], rtol=1e-5, atol=1e-5)


def test_load_params_slices_a_full_checkpoint(tmp_path):
    """load_params(mesh=) into a sharded model: each rank's parameters are
    its slices of the file's full arrays (rank 1 of tp 2 here)."""
    full = _seeded(UNetModel(**TINY))
    path = str(tmp_path / "w.ckpt")
    ckpt.save_checkpoint(path, {"params": jax_params_from_state_dict(full.state_dict(), full),
                                "ema_params": (), "step": 0})
    mesh = _tp_mesh(rank=1)
    model = pmesh.shard_params(mesh, UNetModel(**TINY))
    common.load_params(path, model, mesh=mesh)
    axes = pmesh.sharded_params(model)
    assert len(axes) > 0
    for k, p in model.named_parameters():
        want = full.state_dict()[k]
        if k in axes:
            want = want.narrow(axes[k], want.shape[axes[k]] // 2, want.shape[axes[k]] // 2)
        assert torch.equal(p, want), k


def test_production_config_shards_half_of_its_parameters():
    """At the production config and tp 2: 81,460,736 parameters sharded,
    50,312 replicated, 40,780,680 held by a rank."""
    model = common.flagship(device="cpu")
    mesh = _tp_mesh()
    sizes = {True: 0, False: 0}
    for k, p in model.named_parameters():
        sizes[pmesh.param_spec(model, k, mesh) is not None] += p.numel()
    assert sizes == {True: 81_460_736, False: 50_312}
    pmesh.shard_params(mesh, model)
    assert sum(p.numel() for p in model.parameters()) == 40_780_680


def test_dryrun_multichip_eight_ranks_is_jax_mesh():
    """dryrun_multichip(8) picks JAX's data 2 × sp 2 × tp 2; every rank
    agrees on the loss, the gathered parameters and the synthesis."""
    rec = dryrun.dryrun_multichip(8, timeout=TIMEOUT)
    assert rec["mesh"] == {"data": 2, "sp": 2, "tp": 2} and rec["step"] == 1
    assert rec["synthesis_shape"] == [2, 16, 16, 16] and np.isfinite(rec["loss"])


# -- the rank jobs ---------------------------------------------------------------

def test_mesh_indices_and_groups(runs):
    """tp 2: rank r is tp index r, the tp gather is in rank order, no data,
    sp or replica group. (data 1, sp 2, tp 2): rank r is tp index r % 2
    and sp index r // 2; the tp group is consecutive ranks, the sp group
    the ranks of one tp index (its sum: 2·(r % 2) + 2), the replica group
    the same ranks."""
    for r, rec in enumerate(runs["recs"]["two"]):
        m = rec["mesh"]
        assert m["shape"] == {"data": 1, "sp": 1, "tp": 2}
        assert (m["rank"], m["tp_rank"]) == (0, r) and m["tp_gather"] == [0.0, 1.0]
        assert m["sp"] and m["group"] and m["replica"]
    for r, rec in enumerate(runs["recs"]["four"]):
        m = rec["mesh"]
        assert m["shape"] == {"data": 1, "sp": 2, "tp": 2} and m["group"]
        assert (m["rank"], m["sp_rank"], m["tp_rank"]) == (0, r // 2, r % 2)
        assert m["tp_gather"] == [float(r - r % 2), float(r - r % 2 + 1)]
        assert m["sp_sum"] == m["replica_sum"] == float(2 * (r % 2) + 2)


def test_forward_matches_jax_unsharded(runs):
    """fp32 at tp 2 (every rank the whole output) and at (data 1, sp 2,
    tp 2) (every rank its Y slab) against the JAX UNetModel's whole
    output, 5e-5; the gathers logged."""
    ref = runs["ref"]["fwd"]
    for arr in runs["arrays"]["two"]:
        np.testing.assert_allclose(arr["fwd"], ref, atol=5e-5)
    n = LATENT[2] // 2
    for r, arr in enumerate(runs["arrays"]["four"]):
        k = (r // 2) * n
        np.testing.assert_allclose(arr["fwd"], ref[:, :, k:k + n], atol=5e-5)
    for rec in runs["recs"]["two"]:
        b, n_calls = rec["gather"]["tp_gather"]
        assert b > 0 and n_calls > 0


def test_fuse_conv_bf16_on_channel_slices_matches_jax(runs):
    """bf16 fuse_conv at tp 2 (K4b's plain version on each rank's slice of
    the output channels, then the gather): within BF16_FACTOR times what
    bf16 costs the JAX model."""
    ref, ref32 = runs["ref"]["fuse"], runs["ref"]["fuse32"]
    bound = BF16_FACTOR * np.max(np.abs(ref - ref32))
    for arr in runs["arrays"]["two"]:
        assert np.max(np.abs(arr["fuse"] - ref)) <= bound


def _grad_errors(arrays, ref, tag, rank):
    """Largest error of this rank's gradients (input, and each parameter
    against its slice of the unsharded one) relative to its scale."""
    errs = {"gx": np.abs(arrays[f"{tag}gx"] - ref["gx"]).max() / np.abs(ref["gx"]).max()}
    for k, g in ref["grads"].items():
        got = arrays[f"{tag}grad.{k}"]
        if got.shape != g.shape:
            axis = next(d for d, (a, b) in enumerate(zip(got.shape, g.shape)) if a != b)
            n = got.shape[axis]
            g = np.take(g, range(rank * n, (rank + 1) * n), axis=axis)
        errs[k] = np.abs(got - g).max() / max(np.abs(g).max(), 1e-3)
    return errs


def test_sharded_gradients_are_slices_of_the_unsharded(runs):
    """use_checkpoint with a backward at tp 2: each sharded weight's
    gradient is its slice of the port's unsharded gradient, the replicated
    ones and the input's whole, 1e-5 of their scale. The same check
    refuses a reduce-scatter backward of the gather (summing the ranks'
    gradients): it doubles every gradient upstream of a gather."""
    ref = runs["ref"]
    for r, arr in enumerate(runs["arrays"]["two"]):
        errs = _grad_errors(arr, ref, "", r)
        assert max(errs.values()) <= 1e-5, errs
        bad = _grad_errors(arr, ref, "rs.", r)
        assert bad["gx"] > 0.5 and max(bad.values()) > 0.5


def test_train_step_matches_jax(runs):
    """A train step at tp 2 and at (data 1, sp 2, tp 2): the loss (rtol
    2e-5) and mse_wav (rtol 2e-4) of JAX's unsharded step; each rank's
    parameters after one AdamW step its slices of JAX's within 5e-3·lr,
    and Adam's first moment (linear in the gradients, where the step's
    sign-like update is not) within 1e-4 of its largest magnitude; the
    replicated parameters the same bits on every rank; the norms the whole
    model's; the sharded gradients reduced apart from the replicated
    ones."""
    jm, jparams, jmu = runs["ref"]["step"], runs["ref"]["params"], runs["ref"]["mu"]
    mu_scale = max(np.abs(v).max() for v in jmu.values())
    for job in ("two", "four"):
        first = runs["arrays"][job][0]
        for r, (rec, arr) in enumerate(zip(runs["recs"][job], runs["arrays"][job])):
            st = rec["step"]
            np.testing.assert_allclose(st["loss"], float(jm["loss"]), rtol=2e-5)
            np.testing.assert_allclose(st["mse_wav"], jm["mse_wav"], rtol=2e-4, atol=1e-6)
            np.testing.assert_allclose(st["grad_max"], float(jm["grad_max"]), rtol=1e-3)
            np.testing.assert_allclose(st["param_max"], float(jm["param_max"]), rtol=1e-6)
            tp_rank = r % 2
            for k, v in jparams.items():
                got = arr[f"param.{k}"]
                mu = jmu[k]
                if k in st["sharded"]:
                    n = got.shape[0]
                    v, mu = v[tp_rank * n:(tp_rank + 1) * n], mu[tp_rank * n:(tp_rank + 1) * n]
                else:
                    assert np.array_equal(got, first[f"param.{k}"]), k
                assert got.shape == v.shape and np.abs(got - v).max() <= 5e-3 * LR, k
                assert np.abs(arr[f"mu.{k}"] - mu).max() <= 1e-4 * mu_scale, k
            # the slices' all-reduce over the replica group: none where it
            # is this rank alone
            assert st["comm"]["allreduce"][1] == (2 if job == "four" else 1)
            assert st["comm"]["tp_gather"][0] > 0 and st["comm"]["tp_reduce"][0] > 0
        assert len(runs["recs"][job][0]["step"]["sharded"]) > 0


def test_db2_on_sp_slabs_matches_jax(runs):
    """db2's normalized DWT and IDWT at sp 2 (each rank's slab with its
    neighbour's halo planes, zeros at the volume's edges): every rank's Y
    slab of the whole transform, against the port's one process (1e-6) and
    JAX's ``dwt_normalized``/``idwt_normalized`` (1e-5)."""
    ref = runs["ref"]
    for r, arr in enumerate(runs["arrays"]["four"]):
        for k, n in (("dwt", 4), ("idwt", 8)):
            y0 = (r // 2) * n
            assert arr[f"db2.{k}"].shape[2] == n
            for src, atol in (("db2.one.", 1e-6), ("db2.", 1e-5)):
                np.testing.assert_allclose(arr[f"db2.{k}"], ref[f"{src}{k}"][:, :, y0:y0 + n],
                                           atol=atol)


# dpm++ 3 steps amplifies float32 rounding between the port's and JAX's
# chains: the port's chain tolerance, 1e-4 (tests/test_torch_synthesis.py)
SYNTH_ATOL = 1e-4


def test_synthesis_over_tp_matches_jax_unsharded(runs):
    """make_synthesis_fn(mesh=) at tp 2, ddpm 4 steps and dpm++ 3: the same
    whole batch on both ranks, eager, against JAX's unsharded run with the
    same key stream (1e-4)."""
    ref = runs["ref"]
    a, b = runs["arrays"]["two"]
    for k in ("ddpm", "dpm"):
        assert a[f"synth.{k}"].shape == ref[f"synth.{k}"].shape == (2, 16, 16, 16)
        assert ref[f"synth.{k}"].max() > 0
        assert np.array_equal(a[f"synth.{k}"], b[f"synth.{k}"])
        np.testing.assert_allclose(a[f"synth.{k}"], ref[f"synth.{k}"], atol=SYNTH_ATOL)
    assert all(rec["chain"] for rec in runs["recs"]["two"])


def test_checkpoint_under_tp_is_one_process_bytes(runs, tmp_path):
    """cli.train --tensor_mesh 2: the losses of one process (2e-5), rank 0
    alone writing; its BEST and optimizer blob are, byte for byte, what
    one process writes for the ranks' state with each sharded tensor's
    slices concatenated; resumed from that BEST at tp 2, the next step's
    loss is one process's from the same file (2e-5)."""
    recs, arrays, ref = runs["recs"]["two"], runs["arrays"]["two"], runs["ref"]
    for rec in recs:
        tr = rec["train"]
        assert tr["step"] == 2 and tr["count"] == 2
        np.testing.assert_allclose(tr["losses"], ref["one_losses"], atol=2e-5)
        assert all(b > 0 for b in tr["tp_gather_bytes"])
        assert rec["resume"]["resume_step"] == 2 and rec["resume"]["steps"] == [3]
        np.testing.assert_allclose(rec["resume"]["losses"], ref["resume_losses"], atol=2e-5)
    assert recs[0]["train"]["writes"] and not recs[1]["train"]["writes"]
    model = ref["model"]
    full = {}
    for group in ("params", "ema", "mu", "nu"):
        full[group] = {}
        for k, p in model.named_parameters():
            parts = [a[f"state.{group}.{k}"] for a in arrays]
            if parts[0].shape == tuple(p.shape):
                assert np.array_equal(parts[0], parts[1]), (group, k)
                full[group][k] = parts[0]
            else:
                axis = next(d for d, (x, y) in enumerate(zip(parts[0].shape, p.shape)) if x != y)
                full[group][k] = np.concatenate(parts, axis)
    ckpt.save_checkpoint(str(tmp_path / "one.ckpt"), {
        "params": jax_params_from_state_dict(full["params"], model),
        "ema_params": (jax_params_from_state_dict(full["ema"], model),), "step": 2})
    opt = train.make_optimizer(LR, lr_anneal_steps=2)
    ckpt.save_checkpoint(str(tmp_path / "opt.ckpt"), {"opt_state": opt.state_to_tree(
        {"count": 2, "mu": {k: torch.from_numpy(v) for k, v in full["mu"].items()},
         "nu": {k: torch.from_numpy(v) for k, v in full["nu"].items()}}, model)})
    for mine, theirs in (("one.ckpt", "brats_t1c_BEST_sampled_10.ckpt"),
                         ("opt.ckpt", "opt_best_t1c.ckpt")):
        assert (tmp_path / mine).read_bytes() == (runs["work"] / "ck" / theirs).read_bytes()
