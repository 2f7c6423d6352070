"""The port's quality bench (``fast_cwdm_tpu_torch/scripts/quality_bench.py``):
the harness tests of tests/test_quality_bench.py run against the port's
module, one ``--quick`` ``stage_eval`` of both packages on the same val
phantoms and the same JAX-written tiny fp32 ``.ckpt`` (copy rows equal,
model rows within 1e-4 SSIM / 1e-3 dB PSNR, the port given the JAX key
stream's noise), and a ``--quick`` run of every stage on the CPU."""

import importlib.util
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.scripts import quality_bench as qb
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

_JQB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "scripts", "quality_bench.py")


def _jax_qb():
    spec = importlib.util.spec_from_file_location("jax_quality_bench", _JQB_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(tmp_path, **over):
    argv = [f"--workdir={tmp_path}"]
    argv += [f"--{k}={v}" for k, v in over.items()]
    return qb.parse_args(argv)


# --- the harness (tests/test_quality_bench.py, on the port) ------------------


def test_resume_candidate_empty(tmp_path):
    a = _args(tmp_path)
    assert qb._resume_candidate(a, str(tmp_path), "direct", 1000) == ""


def test_resume_candidate_prefers_step_stamped(tmp_path):
    a = _args(tmp_path)
    cdir = str(tmp_path)
    best = os.path.join(cdir, "brats_t1c_BEST_direct_1000.ckpt")
    stamped = os.path.join(cdir, "brats_t1c_002500_direct_1000.ckpt")
    open(best, "w").close()
    assert qb._resume_candidate(a, cdir, "direct", 1000) == best
    open(stamped, "w").close()
    assert qb._resume_candidate(a, cdir, "direct", 1000) == stamped
    assert qb._resume_candidate(a, cdir, "sampled", 10) != stamped


def test_stage_train_skips_on_done_marker(tmp_path, monkeypatch):
    a = _args(tmp_path, schedules="direct:1000")
    cdir = qb.ckpt_dir_for(a, "direct", 1000)
    os.makedirs(cdir)
    open(os.path.join(cdir, ".done"), "w").close()
    monkeypatch.setattr(qb, "_run_train_leg",
                        lambda a_, argv: pytest.fail("train must not run when .done exists"))
    qb.stage_train(a, str(tmp_path / "train"))


def test_stage_train_passes_resume_and_device_flags(tmp_path, monkeypatch):
    a = _args(tmp_path, schedules="direct:1000", device="cpu")
    cdir = qb.ckpt_dir_for(a, "direct", 1000)
    os.makedirs(cdir)
    stamped = os.path.join(cdir, "brats_t1c_002500_direct_1000.ckpt")
    open(stamped, "w").close()
    seen = {}

    def fake_leg(a_, argv):
        seen.setdefault("argv", argv)
        return "completed"

    monkeypatch.setattr(qb, "_run_train_leg", fake_leg)
    qb.stage_train(a, str(tmp_path / "train"))
    assert f"--resume_checkpoint={stamped}" in seen["argv"]
    assert "--device=cpu" in seen["argv"]
    # the production flags are the JAX harness's, plus --device
    jqb = _jax_qb()
    ja = jqb.parse_args([f"--workdir={tmp_path}", "--schedules=direct:1000"])
    assert qb.model_flags(a) == jqb.model_flags(ja)
    assert os.path.exists(os.path.join(cdir, ".done"))


def test_stage_train_preemption_is_not_completion(tmp_path, monkeypatch):
    a = _args(tmp_path, schedules="direct:1000")
    cdir = qb.ckpt_dir_for(a, "direct", 1000)
    os.makedirs(cdir)
    monkeypatch.setattr(qb, "_run_train_leg", lambda a_, argv: "preempted")
    with pytest.raises(SystemExit) as ei:
        qb.stage_train(a, str(tmp_path / "train"))
    assert ei.value.code == 143
    assert not os.path.exists(os.path.join(cdir, ".done"))


@pytest.mark.parametrize("preempted,status", [(False, "completed"), (True, "preempted")])
def test_quick_mode_trains_in_process(tmp_path, monkeypatch, preempted, status):
    a = _args(tmp_path, schedules="direct:100")
    a.quick = True
    import fast_cwdm_tpu_torch.cli.train as train_cli

    class Loop:
        pass

    loop = Loop()
    loop.preempted = preempted
    monkeypatch.setattr(train_cli, "main", lambda argv: loop)
    monkeypatch.setattr(qb.subprocess, "Popen",
                        lambda *a_, **k: pytest.fail("quick mode must stay in-process"))
    assert qb._run_train_leg(a, ["--x"]) == status


class _FakeProc:
    def __init__(self, rc, hang_first=False):
        self.rc, self.hang_first = rc, hang_first
        self.signals, self.killed = [], False

    def wait(self, timeout=None):
        if self.hang_first and not self.signals:
            raise qb.subprocess.TimeoutExpired("train", timeout)
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)

    def kill(self):
        self.killed = True


@pytest.mark.parametrize("rc,status", [(0, "completed"), (143, "preempted"), (1, "failed(rc=1)")])
def test_run_train_leg_exit_code_mapping(tmp_path, monkeypatch, rc, status):
    a = _args(tmp_path)
    seen = {}

    def popen(cmd, **kw):
        seen.update(cmd=cmd, **kw)
        return _FakeProc(rc)

    monkeypatch.setattr(qb.subprocess, "Popen", popen)
    assert qb._run_train_leg(a, ["--x"]) == status
    assert seen["cmd"][1:] == ["-m", "fast_cwdm_tpu_torch.cli.train", "--x"]
    assert seen["cwd"] == qb.REPO and os.path.isdir(os.path.join(qb.REPO, "fast_cwdm_tpu_torch"))


def test_run_train_leg_wall_budget_sigterm(tmp_path, monkeypatch):
    a = _args(tmp_path, max_wall_hours="0.001")
    proc = _FakeProc(143, hang_first=True)
    monkeypatch.setattr(qb.subprocess, "Popen", lambda *a_, **k: proc)
    assert qb._run_train_leg(a, ["--x"]) == "preempted"
    assert proc.signals == [signal.SIGTERM]


def test_eval_rows_roundtrip_and_resume(tmp_path):
    a = _args(tmp_path)
    assert qb.load_rows(a) == []
    rows = [
        {"model": "-", "leg": "copy-t1n", "evals": 0, "ssim_mean": 0.5,
         "ssim_min": 0.4, "psnr_mean": 20.0, "s_per_volume": None},
        {"model": "direct-1000", "leg": "ddpm-100", "evals": 100,
         "ssim_mean": 0.9, "ssim_min": 0.8, "psnr_mean": 30.0, "s_per_volume": 12.9},
    ]
    qb.dump_rows(a, rows)
    assert qb.load_rows(a) == rows
    assert not os.path.exists(qb.quality_json_path(a) + ".tmp")
    done = {(r["model"], r["leg"]) for r in qb.load_rows(a)}
    assert ("direct-1000", "ddpm-100") in done


def test_quick_mode_never_weakens_to_invalid_schedule():
    a = qb.parse_args(["--workdir=/tmp/x", "--quick"])
    assert a.device == "cuda"  # --quick too runs on the card unless --device cpu is given
    assert qb.parse_args(["--workdir=/tmp/x"]).device == "cuda"
    assert qb.parse_args(["--workdir=/tmp/x", "--quick", "--device=cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        qb.parse_args(["--nonsense"])
    qb.apply_quick(a)
    assert a.schedules == "direct:100,sampled:4"
    assert a.train_steps == 60
    b = qb.parse_args(["--workdir=/tmp/x", "--quick", "--schedules=direct:80"])
    qb.apply_quick(b)
    assert b.schedules == "direct:80"


def test_sampler_legs_and_render_md_match_jax(tmp_path):
    jqb = _jax_qb()
    a = _args(tmp_path)
    ja = jqb.parse_args([f"--workdir={tmp_path}"])
    assert qb._sampler_legs(a) == jqb._sampler_legs(ja)
    with pytest.raises(ValueError):
        qb._sampler_legs(_args(tmp_path, samplers="euler:3"))
    legacy = [{"model": "m", "leg": "l", "evals": 5, "ssim_mean": 0.9, "ssim_min": 0.8,
               "psnr_mean": 30.0, "s_per_volume": 1.5}]
    out = qb.render_md(a, legacy)
    assert "texture" not in out and out == jqb.render_md(ja, legacy)
    rows = legacy + [{"model": "m", "leg": "t", "evals": 5, "ssim_mean": 0.9, "ssim_min": 0.8,
                      "psnr_mean": 30.0, "texture_ratio": 0.87, "s_per_volume": 1.5}]
    out = qb.render_md(a, rows)
    assert "| 0.870 |" in out and "| 30.00 | — | 1.5 |" in out.splitlines()[2]
    assert out == jqb.render_md(ja, rows)


def test_quality_bench_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    for extra in ([], ["--quick"]):  # --quick does not move the run to the CPU
        with pytest.raises(RuntimeError, match="no GPU"):
            qb.main([f"--workdir={tmp_path / 'w'}"] + extra)
        assert not (tmp_path / "w").exists()


# --- stage_eval against the JAX package's ------------------------------------


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """Two --quick val phantoms (seeds 10000, 10001) and a JAX-written tiny
    fp32 BEST .ckpt (raw weights and one EMA shadow) for sampled:4, in two
    workdirs, one per package."""
    from fast_cwdm_tpu.cli import common as jcommon
    from fast_cwdm_tpu.cli import train as jtrain
    from fast_cwdm_tpu.training import bridge
    from fast_cwdm_tpu.training import checkpoints as jckpt
    from fast_cwdm_tpu.models import model_and_diffusion_defaults

    base = tmp_path_factory.mktemp("qb")
    flags = ["--quick", "--schedules=sampled:4", "--train_cases=0", "--val_cases=2"]
    a = qb.parse_args([f"--workdir={base / 'ours'}", "--device=cpu"] + flags)
    qb.apply_quick(a)
    _, val = qb.stage_gen(a)
    jqb = _jax_qb()
    ja = jqb.parse_args([f"--workdir={base / 'ref'}"] + flags)
    jqb.apply_quick(ja)
    jargs = jtrain.create_argparser().parse_args(jqb.model_flags(ja) + ["--data_dir=unused"])
    cfg = {k: v for k, v in vars(jargs).items() if k in model_and_diffusion_defaults()}
    cfg.update(mode="i2i", sample_schedule="sampled", diffusion_steps=4)
    model, _ = common.build_model_and_diffusion(cfg)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    jmodel, _ = jcommon.build_model_and_diffusion(cfg)
    params = bridge.torch_to_flax(sd, jmodel)
    ema = bridge.torch_to_flax({k: 0.5 * v for k, v in sd.items()}, jmodel)
    cdir = qb.ckpt_dir_for(a, "sampled", 4)
    jckpt.save_checkpoint(os.path.join(cdir, jckpt.best_checkpoint_name("t1c", "sampled", 4)),
                          {"params": params, "ema_params": (ema,), "step": 4},
                          config={**cfg, "contr": "t1c"})
    shutil.copytree(val, os.path.join(base / "ref", "val"))
    shutil.copytree(cdir, jqb.ckpt_dir_for(ja, "sampled", 4))
    return a, ja, jqb, val


def _with_jax_noise(monkeypatch, seed):
    """The port's synthesis handed the JAX key stream's noise: stage_eval
    keys case ``idx`` with ``fold_in(PRNGKey(seed + 1), idx)``."""
    real = common.make_synthesis_fn

    def patched(model, diffusion, **kw):
        run = real(model, diffusion, **kw)
        calls = iter(range(1000))

        def wrapped(cond, mask, generator):
            key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), next(calls))
            shape = (cond.shape[0], *cond.shape[1:-1], diffusion.target_channels)
            k0, kl = jax.random.split(key)
            noise = np.array(jax.random.normal(k0, shape))
            steps = np.stack([np.array(jax.random.normal(k, shape))
                              for k in jax.random.split(kl, diffusion.num_timesteps)])
            return run(cond, mask, noise=noise, step_noise=steps)

        return wrapped

    monkeypatch.setattr(common, "make_synthesis_fn", patched)


def test_stage_eval_matches_jax(eval_tree, monkeypatch):
    a, ja, jqb, val = eval_tree
    monkeypatch.setenv("FAST_CWDM_COMPILE_CACHE", "0")
    ref = {(r["model"], r["leg"]): r for r in jqb.stage_eval(ja, os.path.join(ja.workdir, "val"))}
    _with_jax_noise(monkeypatch, a.seed)
    ours = {(r["model"], r["leg"]): r for r in qb.stage_eval(a, val)}
    assert list(ours) == list(ref) == [
        ("-", "copy-t1n"), ("-", "copy-t2w"), ("-", "copy-t2f"),
        ("sampled-4", "sampled-4"), ("sampled-4", "sampled-4+ema")]
    for key, r in ours.items():
        j = ref[key]
        assert r.keys() == j.keys() and r["evals"] == j["evals"]
        if key[0] == "-":  # model-free: equal
            for k in ("ssim_mean", "ssim_min", "psnr_mean", "texture_ratio"):
                np.testing.assert_allclose(r[k], j[k], rtol=0, atol=1e-12, err_msg=f"{key} {k}")
            assert r["s_per_volume"] is j["s_per_volume"] is None
        else:
            for k in ("ssim_mean", "ssim_min"):
                np.testing.assert_allclose(r[k], j[k], rtol=0, atol=1e-4, err_msg=f"{key} {k}")
            np.testing.assert_allclose(r["psnr_mean"], j["psnr_mean"], rtol=0, atol=1e-3)
            assert np.isfinite(r["ssim_mean"]) and r["s_per_volume"] > 0
    # the EMA row reads the shadow, not the raw weights
    assert ours[("sampled-4", "sampled-4+ema")]["ssim_mean"] != ours[("sampled-4", "sampled-4")]["ssim_mean"]
    # a resumed eval skips every finished row
    monkeypatch.setattr(common, "make_synthesis_fn", lambda *a_, **k: pytest.fail("re-ran a leg"))
    assert [(r["model"], r["leg"]) for r in qb.stage_eval(a, val)] == list(ours)


def test_quick_run_of_every_stage_on_the_cpu(tmp_path):
    """gen → train (in-process cli.train, a BEST and .done) → eval, on the
    CPU, as ``python -m fast_cwdm_tpu_torch.scripts.quality_bench --quick
    --device cpu``."""
    md = tmp_path / "Q.md"
    rows = qb.main([f"--workdir={tmp_path / 'w'}", "--quick", "--device=cpu", "--schedules=sampled:4",
                    "--train_cases=2", "--val_cases=1", "--train_steps=2", "--save_interval=2",
                    f"--write_md={md}"])
    assert [r["leg"] for r in rows] == ["copy-t1n", "copy-t2w", "copy-t2f",
                                        "sampled-4", "sampled-4+ema"]
    assert all(np.isfinite(r["ssim_mean"]) and -1 <= r["ssim_mean"] <= 1 for r in rows)
    assert os.path.exists(tmp_path / "w" / "ckpt_sampled_4" / ".done")
    assert os.path.exists(tmp_path / "w" / "ckpt_sampled_4" / "brats_t1c_BEST_sampled_4.ckpt")
    assert "| sampled-4 | sampled-4+ema | 4 |" in md.read_text()
