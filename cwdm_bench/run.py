"""Run one cell of the benchmark: see ``cwdm_bench/harness.py``.

    python3 cwdm_bench/run.py --workload synth10.bf16 --seed 7 --seconds 51 --trace 0
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the CUDA driver's cache of kernels compiled at run time, at a fixed path in
# the checkout beside the program's own build (``.cuda_build/``), so that only
# a checkout's first run compiles them; set before anything starts CUDA
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".cuda_build", "nv_compute_cache")

from cwdm_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
