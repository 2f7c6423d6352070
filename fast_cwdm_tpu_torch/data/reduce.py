"""Float32 ``mean`` and ``std`` in numpy 2.0's summation order,
independent of the numpy build.

numpy 2.0 sums a float32 array in chunks of 8192 items (its buffer),
added one after the other to a float32 total; each chunk pairwise: split
in halves (the left one a multiple of 8 long) down to blocks of at most
128, each block summed in 8 interleaved accumulators, every addition
rounded to float32. Newer numpy builds sum in another order on some CPUs,
which moves the last bits of a float32 mean or std. The phantom generator
divides by such a std, so a case's voxels, and every score computed from
them, would depend on the host's numpy. These functions fix the order:
numpy 2.0's results bit for bit, on every host.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 128  # numpy's PW_BLOCKSIZE


def _leaves(n: int, start: int, out: list) -> None:
    """The blocks of the pairwise tree over ``n`` items from ``start``, in
    order."""
    if n <= _BLOCK:
        out.append((start, n))
        return
    n2 = n // 2
    n2 -= n2 % 8
    _leaves(n2, start, out)
    _leaves(n - n2, start + n2, out)


def _block_sums(a: np.ndarray, leaves: list) -> dict:
    """(start, n) → the float32 sum of each block, computed as numpy does:
    under 8 items one by one; else 8 accumulators, combined as
    ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the tail one by one."""
    sums = {}
    for n in sorted({n for _, n in leaves}):
        starts = np.array([s for s, m in leaves if m == n], dtype=np.int64)
        rows = a[starts[:, None] + np.arange(n)]  # (blocks, n)
        if n < 8:
            res = np.zeros(len(starts), np.float32)
            for i in range(n):
                res = res + rows[:, i]
        else:
            r = rows[:, :8].copy()
            for i in range(8, n - n % 8, 8):
                r += rows[:, i:i + 8]
            res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + (
                (r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
            for i in range(n - n % 8, n):
                res = res + rows[:, i]
        sums.update(zip(starts.tolist(), res))
    return sums


_CHUNK = 8192  # numpy's reduction buffer


def _chunk_sum(a: np.ndarray) -> np.float32:
    """The pairwise float32 sum of one chunk."""
    leaves: list = []
    _leaves(a.size, 0, leaves)
    sums = _block_sums(a, leaves)

    def combine(n: int, start: int) -> np.float32:
        if n <= _BLOCK:
            return sums[start]
        n2 = n // 2
        n2 -= n2 % 8
        return np.float32(combine(n2, start) + combine(n - n2, start + n2))

    return np.float32(combine(a.size, 0))


def pairwise_sum(a: np.ndarray) -> np.float32:
    """``a.sum()`` of a float32 array in numpy 2.0's order: the chunks of
    8192 summed pairwise, the chunk sums added in turn."""
    a = np.ascontiguousarray(a, dtype=np.float32).reshape(-1)
    full = a.size // _CHUNK
    # every full chunk has the same tree: 64 blocks of 128, halved evenly
    r = a[:full * _CHUNK].reshape(full, _CHUNK // _BLOCK, _BLOCK)
    acc = r[:, :, :8].copy()
    for i in range(8, _BLOCK, 8):
        acc += r[:, :, i:i + 8]
    level = ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])) + (
        (acc[..., 4] + acc[..., 5]) + (acc[..., 6] + acc[..., 7]))
    while level.shape[1] > 1:
        level = level[:, 0::2] + level[:, 1::2]
    chunk_sums = list(level[:, 0])
    if a.size % _CHUNK or not a.size:
        chunk_sums.append(_chunk_sum(a[full * _CHUNK:]))
    # the chunk sums in turn, from 0: cumsum adds one after the other
    return np.cumsum(np.array([0.0] + chunk_sums, np.float32), dtype=np.float32)[-1]


def mean(a: np.ndarray) -> np.float32:
    """``a.mean()`` of a float32 array: the pairwise sum over the count, the
    quotient taken in float64 and rounded to float32."""
    return np.float32(np.float64(pairwise_sum(a)) / a.size)


def std(a: np.ndarray) -> np.float32:
    """``a.std()`` of a float32 array: the float32 deviations from
    :func:`mean` squared, their pairwise sum over the count (float64 quotient,
    rounded to float32), then the float32 square root."""
    a = np.asarray(a, dtype=np.float32)
    d = a - mean(a)
    return np.sqrt(np.float32(np.float64(pairwise_sum(d * d)) / a.size))
