"""Ordered, bounded thread prefetch of dataset items (port of
``fast_cwdm_tpu/data/loader.py::ThreadedLoader``): NIfTI decode and
normalisation overlap the card's sampling of the previous case."""

from __future__ import annotations

import queue
import threading
from typing import Iterator


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
