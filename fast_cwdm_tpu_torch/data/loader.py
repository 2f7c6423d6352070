"""Input pipeline (port of ``fast_cwdm_tpu/data/loader.py``): an ordered,
bounded thread prefetch of dataset items (NIfTI decode and normalisation
overlap the card's work), the shuffled item order of training and its
per-process row slicing, a prefetch of batches to the device on a side
CUDA stream, and batches whose tensors stay in device memory from the
first epoch on.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


class ThreadedLoader:
    """Yields ``dataset[0], dataset[1], …`` in order, loaded by
    ``num_workers`` threads with at most ``max_prefetch`` items in flight
    (loading, queued or waiting for an earlier one). An item that fails to
    load raises ``RuntimeError`` from the iterator."""

    def __init__(self, dataset, *, num_workers: int = 4, max_prefetch: int = 8):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        # a non-positive permit count would park every worker before its
        # first item and hang the consumer
        self.max_prefetch = max(1, max_prefetch)

    def __iter__(self) -> Iterator:
        idx_q: queue.Queue = queue.Queue()
        out_q: queue.Queue = queue.Queue()
        n = len(self.dataset)
        for i in range(n):
            idx_q.put(i)
        results: dict[int, object] = {}
        stop = threading.Event()
        permits = threading.Semaphore(self.max_prefetch)

        def worker():
            while not stop.is_set():
                # the permit before the index: indices are claimed in order by
                # permit holders, so the smallest unfinished index always holds
                # one and the consumer can always progress
                permits.acquire()
                if stop.is_set():
                    permits.release()
                    return
                try:
                    i = idx_q.get_nowait()
                except queue.Empty:
                    permits.release()
                    return
                try:
                    out_q.put((i, self.dataset[i], None))
                except Exception as e:  # noqa: BLE001 — re-raised by the consumer
                    out_q.put((i, None, e))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            next_idx = received = 0
            while received < n:
                i, item, err = out_q.get()
                received += 1
                if err is not None:
                    raise RuntimeError(f"dataset item {i} failed to load") from err
                results[i] = item
                while next_idx in results:
                    yield results.pop(next_idx)
                    permits.release()
                    next_idx += 1
        finally:
            stop.set()
            for _ in threads:  # unblock workers parked on permits.acquire
                permits.release()


class _PermutedView:
    """Item ``i`` is ``dataset[order[i]]``: lets :class:`ThreadedLoader`,
    which keeps index order, yield a shuffled order."""

    def __init__(self, dataset, order):
        self.dataset = dataset
        self.order = order

    def __len__(self):
        return len(self.order)

    def __getitem__(self, i):
        return self.dataset[int(self.order[i])]


def shard_order_rows(order: np.ndarray, batch_size: int,
                     rows: tuple[int, int]) -> tuple[np.ndarray, int]:
    """Restrict a global sample ``order`` to rows ``[start, stop)`` of every
    ``batch_size``-row batch (a ragged tail is dropped). Returns
    ``(local_order, local_batch_size)``."""
    start, stop = rows
    if not (0 <= start < stop <= batch_size):
        raise ValueError(f"rows {rows} outside batch [0, {batch_size})")
    n_full = len(order) // batch_size
    local = order[: n_full * batch_size].reshape(n_full, batch_size)[:, start:stop].reshape(-1)
    return local, stop - start


def iter_items(dataset, order, num_workers: int = 0) -> Iterator:
    """``dataset`` items in ``order``, decoded on ``num_workers`` threads
    when > 0; the sequence is the same for any worker count."""
    if num_workers > 0:
        return iter(ThreadedLoader(_PermutedView(dataset, order), num_workers=num_workers,
                                   max_prefetch=max(8, num_workers + 2)))
    return (dataset[int(i)] for i in order)


def to_device(batch, device: str | torch.device,
              stream: torch.cuda.Stream | None = None):
    """A batch of numpy arrays or tensors (a dict or one) as tensors on
    ``device``. For a CUDA device a host array is pinned and copied
    asynchronously on ``stream`` (default: the current stream); a tensor
    already there is returned as it is."""
    device = torch.device(device)

    def put(a):
        if isinstance(a, torch.Tensor) and a.device == device:
            return a
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t.to(device)
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            return t.pin_memory().to(device, non_blocking=True)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def prefetch_to_device(iterator: Iterable, *, size: int = 2,
                       device: str | torch.device) -> Iterator:
    """Keep ``size`` batches already on ``device`` while the current step
    runs: a producer thread loads each batch and starts its copy
    (:func:`to_device` on a side CUDA stream), and the consumer's stream
    waits for that copy before the batch is used. An exception in the
    producer is raised by the consumer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device=device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    failure: list[BaseException] = []
    stop = threading.Event()

    def offer(item) -> bool:
        # a consumer that stopped early never drains the queue: give up then
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            it = iter(iterator)
            while not stop.is_set():
                batch = next(it, sentinel)
                if batch is sentinel:
                    break
                out = to_device(batch, device, stream)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(stream)
                if not offer((out, event)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            failure.append(e)
        finally:
            offer(sentinel)

    threading.Thread(target=producer, daemon=True, name="h2d-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            out, event = item
            if event is not None:
                torch.cuda.current_stream(device).wait_event(event)
                # the batch's memory now belongs to the consumer's stream
                for t in (out.values() if isinstance(out, dict) else (out,)):
                    t.record_stream(torch.cuda.current_stream(device))
            yield out
    finally:
        stop.set()


def device_resident_batches(dataset, batch_size: int, *, device: str | torch.device,
                            shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                            keys=None, cache: dict | None = None) -> Iterator[dict]:
    """One epoch of batches whose tensors stay on ``device``: each case is
    decoded and copied there once (into ``cache``, which the caller keeps
    across epochs and which holds the device memory), then served from it,
    so later epochs copy nothing from the host. The batch sequence is
    ``brats.iterate_batches``' for the same ``shuffle`` and ``seed``. A case
    missing a collated modality raises, naming the case."""
    from fast_cwdm_tpu_torch.data.brats import MODALITIES

    keys = MODALITIES if keys is None else keys
    cache = {} if cache is None else cache
    device = torch.device(device)

    def cached(i: int) -> dict:
        got = cache.get(i)
        if got is None:
            item = dataset[int(i)]
            if item.get("missing", "none") in keys:
                where = item.get("filedict") or item.get("subj") or "?"
                raise ValueError(
                    f"case is missing modality {item['missing']!r} but batches collate keys "
                    f"{tuple(keys)}; offending case files: {where}")
            # with the batch axis, so that at batch 1 a step's batch is the
            # cached dict itself
            got = {k: torch.from_numpy(np.array(item[k])[None]).to(device) for k in keys}
            cache[i] = got
        return got

    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order) // batch_size
    if not drop_last and len(order) % batch_size:
        n += 1
    for b in range(n):
        items = [cached(i) for i in order[b * batch_size:(b + 1) * batch_size]]
        yield items[0] if len(items) == 1 else {k: torch.cat([it[k] for it in items]) for k in keys}
