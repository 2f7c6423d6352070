"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``ops/csrc/<name>.cu`` exports a plain C interface and is compiled by
its own ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` call
into ``.cuda_build/`` at the repository root, at first use. The library
name carries a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused. :func:`build` starts one ``nvcc``
per source, all at once, so the build costs the slowest file, not the sum.

No PyTorch headers are compiled (binding by ``ctypes``): a source builds
in seconds instead of minutes. Nothing here runs when the package is
imported; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".cuda_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register/shared-memory report of each source built in this process
PTXAS_REPORT: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of fast_cwdm_tpu_torch are built from source at first use"
        )
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns seconds per source built
    (0.0 where the library was already there). Raises with the compiler's
    output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            target,
        )
    seconds = {n: 0.0 for n in names}
    failures = []
    for name, (proc, tmp, target) in running.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        PTXAS_REPORT[name] = out
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: readers never see a partial .so
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def check(status: int, kernel: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel} failed to launch: cudaError {status}"
        )
