"""The native (C++) NIfTI decoder: GIL-releasing decode and a fused
quantile clip/normalize (the port's copy of ``fast_cwdm_tpu/data/native``,
with its contract: :func:`get_lib`, :func:`available`, :func:`load_volume`,
:func:`clip_and_normalize_inplace`, and ``FAST_CWDM_NATIVE=0`` read by
``data/brats.py::load_preprocessed``).

``fastnifti.cpp`` is built with ``g++ -O3 -shared -fPIC`` at first use into
``.cuda_build/`` at the repository root (gitignored), linked against zlib
(``-lz``), under a name that carries a hash of the source and flags,
through a per-process temporary file and an atomic rename, so concurrent
first uses never load a half-written library.

A missing ``g++`` or zlib, or a failed build, makes :func:`available` False
and :func:`load_volume` return None: the caller then takes the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fastnifti.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".cuda_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LINK_FLAGS = ("-lz",)

_lock = threading.Lock()
_lib = None
_tried = False


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libfastnifti_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    # a per-process temporary: concurrent cold starts each link their own
    # file, and the rename is atomic (loaders see no library or a whole one)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), *LINK_FLAGS, "-o", str(tmp)]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p, c_float_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    lib.fastnifti_probe.restype = ctypes.c_int
    lib.fastnifti_probe.argtypes = [ctypes.c_char_p, c_int_p]
    lib.fastnifti_load.restype = ctypes.c_long
    lib.fastnifti_load.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_long, c_int_p,
                                   c_float_p, c_int_p]
    lib.fastnifti_clip_normalize.restype = None
    lib.fastnifti_clip_normalize.argtypes = [c_float_p, ctypes.c_long, ctypes.c_double,
                                             ctypes.c_double]
    return lib


def get_lib():
    """ctypes handle to libfastnifti (built first if needed), or None if it
    cannot be built or loaded. The result is kept for the process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = _target()
        if not target.exists() and not _build(target):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(target)))
        except OSError:
            return None
        return _lib


def available() -> bool:
    return get_lib() is not None


def load_volume(path: str) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode a NIfTI volume natively → (float32 F-ordered array, affine).

    Returns None if the native library is unavailable or the file uses an
    unsupported feature (the caller falls back to the Python reader).
    ``load_volume.decodes`` counts the volumes it returned."""
    lib = get_lib()
    if lib is None:
        return None
    dims = (ctypes.c_int * 8)()
    nd = lib.fastnifti_probe(path.encode(), dims)
    if nd <= 0:
        return None
    shape = tuple(dims[1: 1 + nd])
    n = int(np.prod(shape))
    out = np.empty(n, dtype=np.float32)
    affine_rows = (ctypes.c_float * 12)()
    has_sform = ctypes.c_int(0)
    got = lib.fastnifti_load(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             n, dims, affine_rows, ctypes.byref(has_sform))
    if got != n:
        return None
    vol = out.reshape(shape, order="F")
    affine = np.eye(4)
    if has_sform.value:
        affine[:3, :4] = np.frombuffer(bytes(affine_rows), dtype=np.float32).reshape(3, 4)
    with _lock:
        load_volume.decodes += 1
    return vol, affine


load_volume.decodes = 0


def clip_and_normalize_inplace(
    vol: np.ndarray, qlo: float = 0.001, qhi: float = 0.999
) -> np.ndarray | None:
    """Native fused quantile clip + min-max normalize (in place on a
    contiguous float32 array). Returns the array, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if vol.dtype != np.float32 or not vol.flags["FORC"]:
        raise ValueError("clip_and_normalize_inplace needs a contiguous float32 array, "
                         f"got {vol.dtype} (C: {vol.flags['C_CONTIGUOUS']}, "
                         f"F: {vol.flags['F_CONTIGUOUS']})")
    flat = vol.reshape(-1, order="A")
    lib.fastnifti_clip_normalize(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 flat.size, qlo, qhi)
    return vol
