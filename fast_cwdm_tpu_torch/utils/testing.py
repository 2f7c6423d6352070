"""Deterministic seeded weights (port of ``fast_cwdm_tpu/utils/testing.py``).

``seeded_state_dict`` makes reproducible pseudo-random weights keyed by
tensor NAME and shape, so both sides of a parity check (and the
production-size golden fixture) regenerate identical weights from the
torch key names: >=2-D tensors ``N(0, fan_in^-1/2)``, 1-D ``*.weight``
(GroupNorm scales) ``1 + 0.05·N(0,1)``, everything else ``0.02·N(0,1)``.
"""
from __future__ import annotations

import zlib

import numpy as np


def seeded_tensor(name: str, shape: tuple[int, ...]) -> np.ndarray:
    """Deterministic float32 array keyed by ``(name, shape)``."""
    seed = zlib.crc32(f"{name}:{shape}".encode()) & 0xFFFFFFFF
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal(shape)
    if len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        arr = arr / np.sqrt(max(fan_in, 1))
    elif name.endswith(".weight"):  # GroupNorm scale
        arr = 1.0 + 0.05 * arr
    else:
        arr = 0.02 * arr
    return arr.astype(np.float32)


def seeded_state_dict(
    shapes: dict[str, tuple[int, ...]]
) -> dict[str, np.ndarray]:
    """Torch-keyed state_dict of :func:`seeded_tensor` arrays."""
    return {k: seeded_tensor(k, tuple(s)) for k, s in shapes.items()}
