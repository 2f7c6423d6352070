"""The port's data axis over torch.distributed (``parallel/``), on the CPU:
two ``gloo`` ranks in child processes against the port's single process
and the JAX package.

- the mesh object, ``setup_distributed``'s refusals, ``local_batch_rows``
  and ``shard_batch``;
- a 2-rank train step on global batch 2 (3 steps) against the port's
  single-process step and JAX's (``tests/test_parallel.py:93``), with
  gradient accumulation (``:122``) and with the loss-aware sampler, whose
  gathered history must be the same on both ranks;
- ``make_synthesis_fn(mesh=)`` against the unsharded batch;
- ``cli.train`` as two ranks (``tests/test_parallel.py:509``, ``.ckpt``):
  each rank's rows, the gathered metrics, rank-0-only writes, and the
  losses of one process on the same global batch;
- SIGTERM to rank 1 only stops both ranks after one step, rank 0 saves;
- ``parallel.dryrun.dryrun_multichip(2)``.

The children import no JAX; the JAX side runs here. Each child gets at
most ``TIMEOUT`` seconds. Tolerances are the training tests'
(tests/test_torch_training.py: loss 2e-5, parameters 5e-3·lr plus two
float32 ulps, Adam eps 1e-3 on every side) and 1e-5 for the synthesized
volumes.
"""

import json
import os
import signal
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from fast_cwdm_tpu.models import UNetModel as JUNet
from fast_cwdm_tpu.training import TrainState as JTrainState
from fast_cwdm_tpu.training import make_optimizer as jmake_optimizer
from fast_cwdm_tpu.training import make_train_step as jmake_train_step
from fast_cwdm_tpu.training.bridge import flax_to_torch, torch_to_flax
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.cli import train as cli_train
from fast_cwdm_tpu_torch.data import nifti
from fast_cwdm_tpu_torch.diffusion import resample
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.parallel import dryrun
from fast_cwdm_tpu_torch.parallel import mesh as pmesh
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training import state as tstate
from fast_cwdm_tpu_torch.training import train
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

TIMEOUT = 120
MODALITIES = ("t1n", "t1c", "t2w", "t2f")
LR, EPS = 1e-4, 1e-3
TINY = dict(image_size=8, in_channels=32, model_channels=16, out_channels=8, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3, num_groups=8,
            resblock_updown=True, bottleneck_attention=False, resample_2d=False)
TINY_FLAGS = ["--num_channels=16", "--num_res_blocks=1", "--channel_mult=1,2",
              "--attention_resolutions=", "--num_groups=8", "--bottleneck_attention=False",
              "--image_size=8", "--resample_2d=False", "--use_scale_shift_norm=False",
              "--resblock_updown=True", "--mode=i2i", "--dtype=float32",
              "--diffusion_steps=10", "--sample_schedule=sampled", "--device=cpu"]
# (global batch, accum_steps, loss-aware sampler, steps) of each step variant
VARIANTS = {"plain": (2, 1, False, 3), "accum": (4, 2, False, 2), "sampler": (2, 1, True, 3)}


def _tiny():
    model = UNetModel(**TINY)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, sd


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    return {m: rng.random((b, 8, 8, 8, 1)).astype(np.float32) for m in MODALITIES}


def _diffusion(steps=10):
    return GaussianDiffusion.named("linear", steps, "sampled", mode="i2i")


# ---------------------------------------------------------------------------
# One 2-rank run: the mesh, the batch rows, three step variants, synthesis
# ---------------------------------------------------------------------------

_CORE_CHILD = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["TEST_DIR"])
from fast_cwdm_tpu_torch.parallel import mesh as pm
pm.setup_distributed("cpu")
from test_torch_parallel_child import run
run(sys.argv[1])
"""


def _core(workdir):
    """The 2-rank body (run in the child, imported without JAX)."""
    from fast_cwdm_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh()
    out = {"shape": mesh.shape, "rank": mesh.rank, "size": mesh.size,
           "rows": {b: pm.local_batch_rows(mesh, b) for b in (2, 4, 8)},
           "hybrid": pm.make_hybrid_mesh().shape, "refusals": {}}
    sp_mesh = pm.make_mesh(sp=2)
    out["sp_mesh"] = [sp_mesh.shape, sp_mesh.rank, sp_mesh.sp_rank, sp_mesh.group is None]
    for name, fn in (("sp", lambda: pm.make_mesh(data=2, sp=2)),
                     ("tp", lambda: pm.make_mesh(data=2, tp=2)),
                     ("data", lambda: pm.make_mesh(data=3)),
                     ("rows", lambda: pm.local_batch_rows(mesh, 3))):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out["refusals"][name] = [type(e).__name__, str(e)]
    g = np.arange(12, dtype=np.float32).reshape(4, 3)
    lo, hi = pm.local_batch_rows(mesh, 4)
    out["shard"] = pm.shard_batch(mesh, {"x": g}, device="cpu")["x"].tolist()
    out["shard_local"] = pm.shard_batch(mesh, g[lo:hi], global_batch=4, device="cpu").tolist()
    out["gathered"] = pm.all_gather_rows(mesh, torch.tensor([float(mesh.rank)])).tolist()
    out["any"] = [pm.any_rank(mesh, mesh.rank == 1), pm.any_rank(mesh, False)]
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    arrays = {}
    for name, (gb, accum, loss_aware, n_steps) in VARIANTS.items():
        model, _ = _tiny()
        opt = train.make_optimizer(LR, lr_anneal_steps=4, eps=EPS)
        sampler = resample.LossSecondMomentResampler(10, history_per_term=1) if loss_aware else None
        state = tstate.TrainState.create(model, opt, ema_rates=(0.99,),
                                         sampler_state=sampler.init_state() if sampler else ())
        step = train.make_train_step(model, _diffusion(), opt, contr="t1n", mode="i2i",
                                     sampler=sampler, accum_steps=accum, mesh=mesh)
        lo, hi = pm.local_batch_rows(mesh, gb)
        local = pm.shard_batch(mesh, _batch(gb), device="cpu")
        rng = train.StepRNG.seeded(5, "cpu")
        for k in range(n_steps):
            if loss_aware:  # t and the noise drawn for the global batch on each rank
                state, m = step(state, local, rng)
            else:
                t = torch.from_numpy(inputs[f"{name}.t{k}"]).long()
                noise = torch.from_numpy(inputs[f"{name}.noise{k}"])
                state, m = step(state, local, t=t, noise_img=noise)
            for key in ("loss", "mse_wav", "grad_max", "param_max", "loss_per_sample", "t"):
                arrays[f"{name}.{key}{k}"] = m[key].numpy()
        for key, p in state.params.items():
            arrays[f"{name}.param.{key}"] = p.detach().numpy()
        for key, v in state.ema_params[0].items():
            arrays[f"{name}.ema.{key}"] = v.numpy()
        if loss_aware:
            arrays[f"{name}.history"] = state.sampler_state.loss_history.numpy()
            arrays[f"{name}.counts"] = state.sampler_state.loss_counts.numpy()
        out[f"{name}.comm"] = step.comm.drain()
    model, _ = _tiny()
    batch = _batch(2, seed=5)
    cond = common.prepare_condition(batch, "t1c", device="cpu")
    for sampler in ("ddpm", "dpm++"):
        run = common.make_synthesis_fn(model, _diffusion(4), crop_z=8, mesh=mesh, device="cpu",
                                       sampler=sampler, sampler_steps=3)
        arrays[f"synth.{sampler}"] = run(cond, batch["t1n"], torch.Generator().manual_seed(7))
    np.savez(os.path.join(workdir, f"rank{mesh.rank}.npz"), **arrays)
    print("RESULT " + json.dumps(out), flush=True)


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """JAX's draws and steps for the plain and accumulated variants, the
    port's single-process steps of every variant (the loss-aware one draws
    its own t and noise from a seeded StepRNG), and the two ranks' records
    and arrays."""
    work = tmp_path_factory.mktemp("core")
    inputs, ref = {}, {}
    for name, (gb, accum, loss_aware, n_steps) in VARIANTS.items():
        model, sd = _tiny()
        opt = train.make_optimizer(LR, lr_anneal_steps=4, eps=EPS)
        ps = resample.LossSecondMomentResampler(10, history_per_term=1) if loss_aware else None
        state = tstate.TrainState.create(model, opt, ema_rates=(0.99,),
                                         sampler_state=ps.init_state() if ps else ())
        step = train.make_train_step(model, _diffusion(), opt, contr="t1n", mode="i2i",
                                     sampler=ps, accum_steps=accum)
        batch = _batch(gb)
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        steps = []
        if loss_aware:
            rng = train.StepRNG.seeded(5, "cpu")
            for _ in range(n_steps):
                state, m = step(state, tbatch, rng)
                steps.append((float(m["loss"]), None, m, None))
            ref[name] = dict(state=state, steps=steps)
            continue
        jmodel = JUNet(**TINY)
        tx = jmake_optimizer(LR, lr_anneal_steps=4, eps=EPS)
        jstep = jmake_train_step(jmodel, JDiffusion.named("linear", 10, "sampled", mode="i2i"),
                                 tx, contr="t1n", mode="i2i", accum_steps=accum)
        jstate = JTrainState.create(torch_to_flax(sd, jmodel), tx, ema_rates=(0.99,))
        key = jax.random.PRNGKey(11)
        for k in range(n_steps):
            key, sub = jax.random.split(key)
            key_t, key_noise, _ = jax.random.split(sub, 3)
            jt = np.array(jax.random.randint(key_t, (gb,), 0, 10))
            noise = np.array(jax.random.normal(key_noise, batch["t1n"].shape, jnp.float32))
            inputs[f"{name}.t{k}"], inputs[f"{name}.noise{k}"] = jt, noise
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), sub)
            np.testing.assert_array_equal(np.asarray(jm["t"]), jt)
            state, m = step(state, tbatch, t=torch.from_numpy(jt).long(),
                            noise_img=torch.from_numpy(noise))
            steps.append((float(m["loss"]), float(jm["loss"]), m, jm))
        ref[name] = dict(jstate=jstate, jmodel=jmodel, state=state, steps=steps)
    np.savez(work / "inputs.npz", **inputs)
    # the child imports _core and its helpers from a copy without JAX
    (work / "test_torch_parallel_child.py").write_text(_child_module())
    script = work / "child.py"
    script.write_text(_CORE_CHILD)
    env = dict(os.environ, TEST_DIR=str(work))
    runs = dryrun.wait_ranks(dryrun.start_ranks(2, [str(script), str(work)], env=env), TIMEOUT)
    recs = dryrun.results(runs)
    arrays = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    return dict(recs=recs, arrays=arrays, ref=ref)


def _child_module() -> str:
    """The source of what the child needs from this file, without JAX."""
    import inspect

    head = (
        "import json, os\nimport numpy as np, torch\n"
        "from fast_cwdm_tpu_torch.cli import common\n"
        "from fast_cwdm_tpu_torch.diffusion import resample\n"
        "from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion\n"
        "from fast_cwdm_tpu_torch.models.unet import UNetModel\n"
        "from fast_cwdm_tpu_torch.training import state as tstate, train\n"
        "from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict\n"
        f"MODALITIES = {MODALITIES!r}\nLR, EPS = {LR!r}, {EPS!r}\nTINY = {TINY!r}\n"
        f"VARIANTS = {VARIANTS!r}\n"
    )
    body = "\n\n".join(inspect.getsource(f) for f in (_tiny, _batch, _diffusion, _core))
    return head + "\n\n" + body + "\n\nrun = _core\n"


def _close_params(ours: dict, jtree, jmodel):
    """|ours − JAX's| ≤ 5e-3·lr + 2⁻²²·|JAX's| leaf by leaf."""
    ref = flax_to_torch(jax.tree.map(np.asarray, jtree), jmodel)
    assert set(ref) == set(ours)
    worst = max(float((np.abs(np.asarray(ours[k]) - ref[k])
                       / (5e-3 * LR + 2.0**-22 * np.abs(ref[k]))).max()) for k in ref)
    assert worst <= 1.0, worst


def test_mesh_object_and_refusals_in_one_process(monkeypatch):
    """Without torchrun: a data axis of 1, no group, rank 0; an sp or a tp
    axis or a data size the one rank cannot hold raises ValueError."""
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"data": 1, "sp": 1} and mesh.group is None and mesh.rank == 0
    assert pmesh.make_hybrid_mesh() == mesh and pmesh.make_mesh(data=1) == mesh
    assert pmesh.local_batch_rows(mesh, 3) == (0, 3)
    with pytest.raises(ValueError, match=r"not divisible by sp\*tp=2"):
        pmesh.make_mesh(tp=2)
    with pytest.raises(ValueError, match="not divisible by sp"):
        pmesh.make_mesh(sp=2)
    with pytest.raises(ValueError, match="exceeds"):
        pmesh.make_mesh(data=2, sp=2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        pmesh.make_mesh(data=2)
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.all_gather_rows(mesh, x) is x and pmesh.any_rank(mesh, True)
    assert torch.equal(pmesh.shard_batch(mesh, x.numpy(), device="cpu"), x)


def test_setup_distributed_refusals(monkeypatch):
    """No variables: a no-op. A partial torchrun set raises and names the
    missing variables. Managed-cluster markers without a rendezvous raise
    unless FAST_CWDM_ALLOW_SINGLE_PROCESS is set."""
    for k in (*pmesh.RENDEZVOUS_VARS, "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
              "OMPI_MCA_orte_hnp_uri", "FAST_CWDM_ALLOW_SINGLE_PROCESS"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.setup_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="missing: LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        pmesh.setup_distributed("cpu")
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(RuntimeError, match="Refusing to degrade"):
        pmesh.setup_distributed("cpu")
    monkeypatch.setenv("FAST_CWDM_ALLOW_SINGLE_PROCESS", "1")
    assert pmesh.setup_distributed("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():  # the default device is cuda, and raises here
        with pytest.raises(RuntimeError, match="no GPU"):
            pmesh.setup_distributed()


def test_two_ranks_mesh_rows_and_shard_batch(core):
    """Each rank: the data axis of 2, its contiguous rows, its rows of a
    global batch moved by shard_batch (or its own rows, checked against
    global_batch), the gather in rank order, the agreed flag."""
    for rank, rec in enumerate(core["recs"]):
        assert rec["rank"] == rank and rec["size"] == 2
        assert rec["shape"] == rec["hybrid"] == {"data": 2, "sp": 1}
        b = {int(k): tuple(v) for k, v in rec["rows"].items()}
        assert b == {2: (rank, rank + 1), 4: (2 * rank, 2 * rank + 2),
                     8: (4 * rank, 4 * rank + 4)}
        rows = np.arange(12, dtype=np.float32).reshape(4, 3)[2 * rank: 2 * rank + 2]
        assert rec["shard"] == rec["shard_local"] == rows.tolist()
        assert rec["gathered"] == [0.0, 1.0] and rec["any"] == [True, False]
        ref = rec["refusals"]
        assert rec["sp_mesh"] == [{"data": 1, "sp": 2}, 0, rank, True]
        assert ref["sp"][0] == "ValueError" and "exceeds" in ref["sp"][1]
        assert ref["tp"][0] == "ValueError" and "data*sp*tp=4 exceeds" in ref["tp"][1]
        assert ref["data"][0] == "ValueError" and "2 rank(s)" in ref["data"][1]
        assert ref["rows"][0] == "ValueError" and "not divisible" in ref["rows"][1]


@pytest.mark.parametrize("name", ["plain", "accum"])
def test_two_rank_step_matches_one_process_and_jax(core, name):
    """Global batch 2 (3 steps), and 4 with accum_steps 2 (2 steps): both
    ranks' loss, per-subband MSE and norms against the port's one process
    and JAX's step; the ranks' rows of loss_per_sample and t; parameters
    and the EMA shadow identical on both ranks and within 5e-3·lr of JAX
    and of one process; one all-reduce a step of every gradient."""
    gb, _, _, n_steps = VARIANTS[name]
    ref = core["ref"][name]
    a0, a1 = core["arrays"]
    for rank, arr in enumerate(core["arrays"]):
        lo, hi = rank * gb // 2, (rank + 1) * gb // 2
        for k, (single, jloss, m, jm) in enumerate(ref["steps"]):
            np.testing.assert_allclose(arr[f"{name}.loss{k}"], single, atol=2e-5)
            np.testing.assert_allclose(arr[f"{name}.loss{k}"], jloss, atol=2e-5)
            np.testing.assert_allclose(arr[f"{name}.mse_wav{k}"], np.asarray(jm["mse_wav"]),
                                       atol=2e-5)
            np.testing.assert_allclose(arr[f"{name}.loss_per_sample{k}"],
                                       np.asarray(jm["loss_per_sample"])[lo:hi], atol=2e-5)
            np.testing.assert_array_equal(arr[f"{name}.t{k}"], np.asarray(jm["t"])[lo:hi])
            for key in ("grad_max", "param_max"):
                np.testing.assert_allclose(arr[f"{name}.{key}{k}"], float(jm[key]), rtol=1e-5)
                np.testing.assert_allclose(arr[f"{name}.{key}{k}"], float(m[key]), rtol=1e-5)
    for key in a0:
        if key.startswith(f"{name}.param.") or key.startswith(f"{name}.ema."):
            assert np.array_equal(a0[key], a1[key]), key  # the same bits on both ranks
    params = {k.split(".", 2)[2]: v for k, v in a0.items() if k.startswith(f"{name}.param.")}
    ema = {k.split(".", 2)[2]: v for k, v in a0.items() if k.startswith(f"{name}.ema.")}
    _close_params(params, ref["jstate"].params, ref["jmodel"])
    _close_params(ema, ref["jstate"].ema_params[0], ref["jmodel"])
    single = {k: v.detach().numpy() for k, v in ref["state"].params.items()}
    worst = max(float(np.abs(params[k] - single[k]).max()) for k in single)
    assert worst <= 5e-3 * LR, worst
    n_grad = sum(v.size for v in single.values())
    for rec in core["recs"]:
        comm = rec[f"{name}.comm"]
        assert len(comm) == n_steps
        # the gradients, then the loss and the 8 subband MSEs, in float32
        assert all(b == 4 * (n_grad + 1 + 8) for b, _ in comm)


def test_the_resampler_history_is_gathered_and_equal_on_both_ranks(core):
    """The loss-aware sampler (history 1), 3 steps, t and the noise drawn
    from a seeded StepRNG for the global batch on each rank: every rank
    records the whole batch's t and losses in rank order, so both ranks'
    state is the same bits, and it matches one process's on the same seed,
    as do the losses."""
    a0, a1 = core["arrays"]
    assert np.array_equal(a0["sampler.history"], a1["sampler.history"])
    assert np.array_equal(a0["sampler.counts"], a1["sampler.counts"])
    ref = core["ref"]["sampler"]
    one = ref["state"].sampler_state
    np.testing.assert_array_equal(a0["sampler.counts"], one.loss_counts.numpy())
    assert int(one.loss_counts.sum()) > 0
    np.testing.assert_allclose(a0["sampler.history"], one.loss_history.numpy(), atol=2e-5)
    for rank, arr in enumerate(core["arrays"]):
        for k, (single, _, m, _) in enumerate(ref["steps"]):
            np.testing.assert_allclose(arr[f"sampler.loss{k}"], single, atol=2e-5)
            np.testing.assert_array_equal(arr[f"sampler.t{k}"], m["t"].numpy()[rank:rank + 1])
    s = resample.LossSecondMomentResampler(10, history_per_term=1)
    with pytest.raises(ValueError, match="axis_name"):
        s.update(s.init_state(), torch.zeros(1, dtype=torch.long), torch.zeros(1), axis_name="sp")


def test_sharded_synthesis_matches_unsharded(core):
    """make_synthesis_fn(mesh=) over two ranks: x_T and each step's noise
    drawn for the whole batch and sliced, the images gathered; every rank
    returns the whole batch, equal to the unsharded run within 1e-5 (ddpm
    and dpm++)."""
    model, _ = _tiny()
    batch = _batch(2, seed=5)
    cond = common.prepare_condition(batch, "t1c", device="cpu")
    for sampler in ("ddpm", "dpm++"):
        run = common.make_synthesis_fn(model, _diffusion(4), crop_z=8, device="cpu",
                                       sampler=sampler, sampler_steps=3)
        ref = run(cond, batch["t1n"], torch.Generator().manual_seed(7))
        a0, a1 = (arr[f"synth.{sampler}"] for arr in core["arrays"])
        assert a0.shape == ref.shape == (2, 8, 8, 8) and ref.max() > 0
        assert np.array_equal(a0, a1)
        np.testing.assert_allclose(a0, ref, atol=1e-5)


# ---------------------------------------------------------------------------
# cli.train as two ranks; SIGTERM to one; the dry run
# ---------------------------------------------------------------------------


def _make_case(case_dir, seed, shape=(24, 24, 8)):
    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = os.path.basename(case_dir)
    for m in MODALITIES:
        vol = (rng.random(shape) * 900 + 100).astype(np.float32)
        nifti.save(nifti.Nifti1Image(vol, np.eye(4)),
                   os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))


_CLI_CHILD = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from fast_cwdm_tpu_torch.cli import train
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training import loop as tloop

writes = []
for name in ("save_checkpoint", "save_if_best"):
    def wrapped(*a, _f=getattr(ckpt, name), _n=name, **kw):
        writes.append(_n)
        return _f(*a, **kw)
    setattr(ckpt, name, wrapped)
fetched = []
fetch = tloop.TrainLoop._fetch
def recording(self, metrics):
    m = fetch(self, metrics)
    fetched.append({k: m[k].tolist() for k in ("loss_per_sample", "t")})
    return m
tloop.TrainLoop._fetch = recording
loop = train.main(sys.argv[1:])
print("RESULT " + json.dumps({
    "rank": int(os.environ["RANK"]), "writes": writes, "fetched": fetched,
    "losses": [r["loss"] for r in loop.step_log], "step": loop.state.step,
    "allreduce_bytes": [r.get("allreduce_bytes_per_step") for r in loop.step_log],
    "distributed_after": torch.distributed.is_initialized()}), flush=True)
"""


def test_cli_train_as_two_ranks(tmp_path, monkeypatch):
    """torchrun-style cli.train, global batch 2 of four cases, two steps
    and a BEST: each rank decodes its row of every batch (the logged rows),
    the per-sample metrics are gathered (2 rows on both ranks), only rank 0
    writes checkpoints, the ledger and log files, and the losses are those
    of one process on the same global batches (within 2e-5)."""
    for i in range(4):
        _make_case(str(tmp_path / "data" / f"0000{i}"), seed=i)
    argv = [f"--data_dir={tmp_path / 'data'}", "--lr=1e-4", "--batch_size=2",
            "--log_interval=1", "--save_interval=2", "--lr_anneal_steps=2",
            "--contr=t1c", "--cache_dataset=True", "--data_mesh=0", *TINY_FLAGS]
    script = tmp_path / "child.py"
    script.write_text(_CLI_CHILD)
    env = dict(os.environ, OPENAI_LOGDIR=str(tmp_path / "log2"))
    runs = dryrun.wait_ranks(dryrun.start_ranks(
        2, [str(script), *argv, f"--checkpoint_dir={tmp_path / 'ck2'}"], env=env), TIMEOUT)
    recs = dryrun.results(runs)
    for rank, (rec, (_, out, _)) in enumerate(zip(recs, runs)):
        assert f"rank {rank} decodes rows [{rank}, {rank + 1}) of each batch of 2" in out
        assert rec["step"] == 2 and not rec["distributed_after"]
        assert len(rec["fetched"]) == 2
        assert all(len(f["loss_per_sample"]) == len(f["t"]) == 2 for f in rec["fetched"])
        assert rec["allreduce_bytes"][0] > 0
    assert recs[0]["fetched"] == recs[1]["fetched"]
    assert recs[0]["losses"] == recs[1]["losses"]
    assert recs[0]["writes"] and not recs[1]["writes"]
    files = sorted(os.listdir(tmp_path / "ck2"))
    assert {"best_losses.txt", "brats_t1c_BEST_sampled_10.ckpt", "opt_best_t1c.ckpt"} <= set(files)
    assert os.path.exists(tmp_path / "log2" / "progress.csv")
    monkeypatch.setenv("OPENAI_LOGDIR", str(tmp_path / "log1"))
    one = cli_train.main(argv + [f"--checkpoint_dir={tmp_path / 'ck1'}"])
    np.testing.assert_allclose(recs[0]["losses"], [r["loss"] for r in one.step_log], atol=2e-5)
    assert "allreduce_bytes_per_step" not in one.step_log[0]


_SIGTERM_CHILD = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.parallel import mesh as pm
from fast_cwdm_tpu_torch.parallel.dryrun import tiny_unet
from fast_cwdm_tpu_torch.training.loop import TrainLoop
from fast_cwdm_tpu_torch.utils import logger

pm.setup_distributed("cpu")
mesh = pm.make_mesh(sp=int(sys.argv[2]))
logger.configure(os.path.join(sys.argv[1], f"log{mesh.process_rank}"), ["log"])
rng = np.random.default_rng(0)
batch = {m: rng.random((2, 8, 8, 8, 1), dtype=np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
lo, hi = pm.local_batch_rows(mesh, 2)
y0, y1 = pm.y_slab(mesh, 8)
local = {k: v[lo:hi, :, y0:y1] for k, v in batch.items()}

def data():
    while True:
        yield local

loop = TrainLoop(model=tiny_unet(8), diffusion=GaussianDiffusion.named("linear", 10, "sampled"),
                 data=data, batch_size=2, log_interval=1, save_interval=10**6, contr="t1n",
                 sample_schedule="sampled", diffusion_steps=10, checkpoint_dir=sys.argv[1],
                 device="cpu", prefetch=0, mesh=mesh)
loop.run_loop()
print("RESULT " + json.dumps({"rank": mesh.process_rank, "step": loop.state.step,
                              "preempted": loop.preempted}), flush=True)
"""


def test_sigterm_to_one_rank_stops_both_and_rank_0_saves(tmp_path):
    """Two TrainLoop ranks with no end; SIGTERM to rank 1 only once it has
    logged a step: the flag is agreed within a step, both ranks return
    preempted after the same step and exit 0, and rank 0 has written that
    step's checkpoint and optimizer blob."""
    _sigterm_to_rank_1(tmp_path, sp=1)


def test_sigterm_to_one_rank_of_an_sp_group_stops_both_and_rank_0_saves(tmp_path):
    """The same with the two ranks as one sp group (``make_mesh(sp=2)``,
    whose groups start gloo threads of their own), each with its Y slab."""
    _sigterm_to_rank_1(tmp_path, sp=2)


def _sigterm_to_rank_1(tmp_path, sp: int) -> None:
    script = tmp_path / "child.py"
    script.write_text(_SIGTERM_CHILD)
    procs = dryrun.start_ranks(2, [str(script), str(tmp_path), str(sp)])
    lines = [[], []]

    def drain(i):
        for line in procs[i].stdout:
            lines[i].append(line)

    readers = [threading.Thread(target=drain, args=(i,), daemon=True) for i in range(2)]
    for r in readers:
        r.start()
    try:
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and not any("[PROFILE] Step" in ln for ln in lines[1]):
            assert all(p.poll() is None for p in procs), [p.stderr.read() for p in procs]
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in readers:
        r.join(timeout=10)
    errs = [p.stderr.read() for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs
    recs = [json.loads(next(ln for ln in lines[i] if ln.startswith("RESULT "))[7:])
            for i in range(2)]
    step = recs[0]["step"]
    assert step >= 1 and recs[1]["step"] == step
    assert recs[0]["preempted"] and recs[1]["preempted"]
    names = ("t1n", step, "sampled", 10)
    assert os.path.exists(tmp_path / ckpt.step_checkpoint_name(*names))
    assert os.path.exists(tmp_path / ckpt.opt_checkpoint_name(*names))
    stamped = [f for f in os.listdir(tmp_path)
               if f.startswith("brats_t1n_") and f.endswith(".ckpt")]
    assert len(stamped) == 1, stamped


_RETURN_CHILD = r"""
import json, os, sys, time
import numpy as np, torch
torch.set_num_threads(1)
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.parallel import mesh as pm
from fast_cwdm_tpu_torch.parallel.dryrun import tiny_unet
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training.loop import TrainLoop
from fast_cwdm_tpu_torch.utils import logger

submit = ckpt.AsyncWriter.submit
def slow(self, fn, *args):  # rank 0's writes land 3 s late
    submit(self, lambda *a: (time.sleep(3.0), fn(*a)), *args)
ckpt.AsyncWriter.submit = slow
pm.setup_distributed("cpu")
mesh = pm.make_mesh()
logger.configure(os.path.join(sys.argv[1], f"log{mesh.rank}"), ["log"])
rng = np.random.default_rng(0)
batch = {m: rng.random((2, 8, 8, 8, 1), dtype=np.float32) for m in ("t1n", "t1c", "t2w", "t2f")}
lo, hi = pm.local_batch_rows(mesh, 2)
local = {k: v[lo:hi] for k, v in batch.items()}

def data():
    while True:
        yield local

loop = TrainLoop(model=tiny_unet(8), diffusion=GaussianDiffusion.named("linear", 10, "sampled"),
                 data=data, batch_size=2, log_interval=1, save_interval=2, lr_anneal_steps=2,
                 contr="t1n", sample_schedule="sampled", diffusion_steps=10,
                 checkpoint_dir=sys.argv[1], device="cpu", prefetch=0, mesh=mesh)
loop.run_loop()
print("RESULT " + json.dumps({"rank": mesh.rank, "files": sorted(os.listdir(sys.argv[1]))}),
      flush=True)
"""


def test_no_rank_returns_before_rank_0s_checkpoint_is_written(tmp_path):
    """Two TrainLoop ranks with a BEST at their last step and rank 0's
    write slowed by 3 s: when ``run_loop`` returns, each rank finds the
    BEST and its optimizer blob on disk, so a resume that follows reads
    the same checkpoint on every rank (rank 1 used to return at once and
    start afresh)."""
    script = tmp_path / "child.py"
    script.write_text(_RETURN_CHILD)
    recs = dryrun.results(dryrun.wait_ranks(dryrun.start_ranks(2, [str(script), str(tmp_path)]),
                                            TIMEOUT))
    for rec in recs:
        assert {"brats_t1n_BEST_sampled_10.ckpt", "opt_best_t1n.ckpt"} <= set(rec["files"]), rec


def test_dryrun_multichip_two_ranks():
    # JAX's choice for two devices (__graft_entry__.py:174-176): sp 2
    rec = dryrun.dryrun_multichip(2, timeout=TIMEOUT)
    assert rec["mesh"] == {"data": 1, "sp": 2} and rec["step"] == 1
    assert rec["synthesis_shape"] == [1, 16, 16, 16] and np.isfinite(rec["loss"])


def test_scaling_bench_at_width_2(capsys):
    """scripts/scaling_bench.py at width 2: sharded synthesis and step equal
    the unsharded ones, and a rank's FLOPs are half the unsharded step's."""
    from fast_cwdm_tpu_torch.scripts import scaling_bench

    assert scaling_bench.main(["--widths", "2", "--timeout", str(TIMEOUT)]) == 0
    row, summary = (json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()[-2:])
    assert row["ok"] and summary["all_ok"] and summary["per_rank_flops_constant"]
    assert row["per_rank_step_gflops"] == [row["unsharded_step_gflops"] / 2] * 2
