"""Threaded prefetching batch loader (the JAX package's
``data/loader.py``).

Decode runs in a thread pool (the native readers release the GIL),
batches are assembled ahead of the consumer into a bounded queue, and
string fields stay lists while array fields are stacked into contiguous
numpy batches, ready for one host-to-device copy.

``rank`` and ``world`` (0 and 1 by default) shard each global batch
across processes as the JAX package does with ``jax.process_index()``
and ``jax.process_count()``: every process walks the same global batch
order (the same shuffle seed) and decodes only its contiguous
``batch_size / world`` slice of each batch. The training entry points
set them from the process group (``parallel.mesh``); a batch the world
does not divide is decoded whole by every process and marked
``_replicated``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np


def _collate(samples: list[dict[str, Any]]) -> dict[str, Any]:
    batch: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals
    return batch


class PrefetchLoader:
    """Iterable over batches of a map-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_threads: int = 8,
                 seed: int | None = None, prefetch: int = 4,
                 rank: int = 0, world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.seed = seed
        self.prefetch = prefetch
        self.rank = rank
        self.world = world
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            seed = self.seed
            if seed is None and self.world > 1:
                # Every process must walk the same global batch order.
                seed = 0
            rng = np.random.default_rng(
                None if seed is None else seed + self._epoch)
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        order = self._index_order()
        pi, pc = self.rank, self.world
        self._epoch += 1
        n_batches = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def safe_put(item) -> bool:
            # Stop-aware blocking put: never blocks forever (the consumer
            # may abandon the iterator with the queue full), never drops
            # the item while the consumer is still listening.
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    def submit(b: int):
                        idxs = order[b * self.batch_size:
                                     (b + 1) * self.batch_size]
                        sharded = pc > 1 and len(idxs) % pc == 0
                        if sharded:
                            per = len(idxs) // pc
                            idxs = idxs[pi * per:(pi + 1) * per]
                        return sharded, [
                            pool.submit(self.dataset.__getitem__, int(i))
                            for i in idxs]

                    # Sliding window: decode a few batches ahead, never the
                    # whole epoch.
                    window: list = []
                    next_b = 0
                    while next_b < n_batches and len(window) <= self.prefetch:
                        window.append(submit(next_b))
                        next_b += 1

                    while window:
                        if stop.is_set():
                            return
                        sharded, futs = window.pop(0)
                        batch = _collate([f.result() for f in futs])
                        if pc > 1 and not sharded:
                            # A trailing batch the world does not divide:
                            # every process decoded all of its rows.
                            batch["_replicated"] = True
                        if not safe_put(batch):
                            return
                        if next_b < n_batches:
                            window.append(submit(next_b))
                            next_b += 1
            except Exception as exc:  # propagate to the consumer
                safe_put(exc)
            finally:
                safe_put(None)  # end-of-epoch sentinel (must not be dropped)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
