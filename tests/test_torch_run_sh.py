"""``fast_cwdm_tpu_torch/run.sh``, the port's launcher: its help and
errors, and, with a stub ``python`` first on ``PATH`` that records its
argv and working directory, that each mode runs the right
``fast_cwdm_tpu_torch.cli`` module from the repository root with the JAX
package's run.sh bundles (its own stubbed run gives the reference argv)."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_SH = os.path.join(REPO, "fast_cwdm_tpu_torch", "run.sh")
JAX_RUN_SH = os.path.join(REPO, "run.sh")

STUB = """#!/bin/bash
{ pwd; printf '%s\\n' "$@"; echo "--END--"; } >> "$STUB_LOG"
"""


def _run(tmp_path, script, *args, env=None):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    stub = bin_dir / "python"
    stub.write_text(STUB)
    stub.chmod(0o755)
    log = tmp_path / f"{os.path.basename(os.path.dirname(script)) or 'root'}.log"
    if log.exists():
        log.unlink()
    full_env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", STUB_LOG=str(log))
    full_env.pop("DIFFUSION_BLOB_LOGDIR", None)
    full_env.update(env or {})
    out = subprocess.run(["bash", script, *args], capture_output=True, text=True, env=full_env,
                         timeout=60)
    calls = []
    if log.exists():
        cur = []
        for line in log.read_text().splitlines():
            if line == "--END--":
                calls.append((cur[0], cur[1:]))
                cur = []
            else:
                cur.append(line)
    return out, calls


def test_help_and_errors(tmp_path):
    out = subprocess.run(["bash", RUN_SH, "--help"], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    for flag in ("--mode", "--sampling-strategy", "--timesteps", "--train_modality"):
        assert flag in out.stdout
    out, calls = _run(tmp_path, RUN_SH, "--mode", "bogus")
    assert out.returncode == 1 and "Unknown mode bogus" in out.stdout and not calls
    out, calls = _run(tmp_path, RUN_SH, "--frobnicate")
    assert out.returncode == 1 and "Unknown option --frobnicate" in out.stdout and not calls


def _same_as_jax(tmp_path, args, module, jax_script, extra_ours=()):
    """run.sh of each package with ``args``: the port runs ``python -m
    module`` with the JAX run.sh's argv (plus ``extra_ours``), from the
    repository root, once per JAX call."""
    out, ours = _run(tmp_path, RUN_SH, *args)
    assert out.returncode == 0, out.stderr
    ref_out, ref = _run(tmp_path, JAX_RUN_SH, *args)
    assert ref_out.returncode == 0, ref_out.stderr
    assert len(ours) == len(ref) >= 1
    for (cwd, argv), (rcwd, rargv) in zip(ours, ref):
        assert cwd == rcwd == REPO
        assert argv[:2] == ["-m", module] and rargv[0] == jax_script
        assert argv[2:] == rargv[1:] + list(extra_ours)
    assert "[TIMING]" in out.stdout
    return ours, out


def test_train_all_modalities(tmp_path):
    ours, out = _same_as_jax(
        tmp_path, ["--mode", "train", "--train_modality", "all", "--sampling-strategy", "sampled",
                   "--timesteps", "10", "--data_dir", "/d", "--checkpoint_dir", "/c",
                   "--extra", "--lr_anneal_steps=4 --log_interval=1"],
        "fast_cwdm_tpu_torch.cli.train", "scripts/train.py")
    assert [next(a for a in argv if a.startswith("--contr=")) for _, argv in ours] == [
        "--contr=t1n", "--contr=t1c", "--contr=t2w", "--contr=t2f"]
    argv = ours[0][1]
    for flag in ("--data_dir=/d", "--checkpoint_dir=/c", "--use_checkpoint=True", "--lr=1e-5",
                 "--sample_schedule=sampled", "--diffusion_steps=10", "--dtype=bfloat16",
                 "--lr_anneal_steps=4", "--log_interval=1", "--num_workers=12"):
        assert flag in argv, flag
    assert out.stdout.count("[TIMING] Training for") == 4


def test_sample_uses_the_newest_best(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "brats_t1c_BEST_sampled_10.ckpt").write_bytes(b"")
    args = ["--mode", "sample", "--train_modality", "t1c", "--checkpoint_dir", str(ckpt),
            "--val_dir", "/v", "--output_dir", "/o", "--sampling-strategy", "sampled",
            "--timesteps", "10"]
    ours, _ = _same_as_jax(tmp_path, args, "fast_cwdm_tpu_torch.cli.sample", "scripts/sample.py")
    argv = ours[0][1]
    assert f"--model_path={ckpt}/brats_t1c_BEST_sampled_10.ckpt" in argv
    assert {"--data_dir=/v", "--output_dir=/o", "--seed=42", "--contr=t1c"} <= set(argv)
    # --extra reaches the sampling CLI too
    out, calls = _run(tmp_path, RUN_SH, *args, "--extra", "--sampler=dpm++ --sampling_steps=10")
    assert calls[0][1][-2:] == ["--sampler=dpm++", "--sampling_steps=10"]
    # no BEST: exit 1 before any CLI runs
    out, calls = _run(tmp_path, RUN_SH, "--mode", "sample", "--checkpoint_dir", str(tmp_path))
    assert out.returncode == 1 and "no checkpoint for t1n" in out.stdout and not calls


def test_auto_and_complete(tmp_path):
    common = ["--val_dir", "/v", "--output_dir", "/o", "--checkpoint_dir", "/c"]
    ours, _ = _same_as_jax(tmp_path, ["--mode", "auto"] + common,
                           "fast_cwdm_tpu_torch.cli.sample_auto", "scripts/sample_auto.py")
    assert {"--data_dir=/v", "--checkpoint_dir=/c", "--seed=42"} <= set(ours[0][1])
    ours, out = _same_as_jax(tmp_path, ["--mode", "complete"] + common,
                             "fast_cwdm_tpu_torch.cli.complete_dataset",
                             "scripts/complete_dataset.py")
    assert ours[0][1][2:] == ["--input_dir=/v", "--output_dir=/o", "--checkpoint_dir=/c"]
    assert "[TIMING] Completion finished" in out.stdout
    out, calls = _run(tmp_path, RUN_SH, "--mode", "complete", *common, "--extra",
                      "--sampler=dpm++ --sampling_steps=10")
    assert calls[0][1] == ["-m", "fast_cwdm_tpu_torch.cli.complete_dataset", "--input_dir=/v",
                           "--output_dir=/o", "--checkpoint_dir=/c", "--sampler=dpm++",
                           "--sampling_steps=10"]


@pytest.mark.parametrize("env,want", [({}, "./checkpoints"), ({"DIFFUSION_BLOB_LOGDIR": "/blob"},
                                                                 "/blob")])
def test_checkpoint_dir_default(tmp_path, env, want):
    out, calls = _run(tmp_path, RUN_SH, "--mode", "complete", env=env)
    assert out.returncode == 0
    assert f"--checkpoint_dir={want}" in calls[0][1]
    assert "--input_dir=./datasets/BRATS2023/validation" in calls[0][1]
