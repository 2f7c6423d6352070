"""What a run loads, and what it does without a card: no module of JAX or of
the JAX package in a run's process (top-level names compared whole), and no
result where no CUDA device is found."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
from cwdm_bench import harness
from cwdm_bench.tests import tiny
for w, c in (("synth10.bf16", "cwdm-bf16"), ("train.bf16", "cwdm-bf16")):
    out = tiny.run(w, c, seconds=0.5, trace=True)
    assert out["attempted"] > 0
for name in ("volumes_per_hour", "volume_s_p85", "train_step_s", "setup_s"):
    harness.load_reader(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=str(ROOT))], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fast_cwdm_tpu_torch" in top and "cwdm_bench" in top
    assert not top & {"jax", "jaxlib", "flax", "fast_cwdm_tpu"}, sorted(top)


def test_the_harness_finds_no_card_and_gives_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "cwdm_bench/run.py", "--workload", "synth10.bf16",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
