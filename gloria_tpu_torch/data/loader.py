"""Threaded host ingest: batches built ahead of the consumer.

The port's own copy of ``gloria_tpu.data.loader`` (the reference's torch
DataLoader workers): a producer thread keeps ``prefetch`` whole-batch builds
in flight on a small thread pool (the per-item numpy / cv2 / native-ingest
work releases the GIL), and hands finished batches to the consumer through
a bounded queue.  ``to_device`` runs in the consumer's thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

THREAD_PREFIX = "PrefetchLoader"
_POLL_S = 0.2  # how often a blocked put looks at the stop flag


class PrefetchLoader:
    """Iterable over batches ready for the device.

    dataset:   indexable returning instance dicts
    collate:   list[instance] → batch dict of numpy arrays
    to_device: batch dict → device batch; identity when None.

    ``batch_size`` is always the global batch.  With ``process_count > 1``
    every process draws the same epoch order (the shuffle RNG is seeded by
    ``seed + epoch`` only) and keeps the contiguous rows
    ``[process_index·L, (process_index+1)·L)`` of each global batch
    (L = batch_size / process_count), so the processes' slices, in process
    order, are the single-process batch row for row.

    A worker's exception is raised to the consumer.  A consumer that stops
    early (``break``) stops the producer: its bounded puts look at a stop
    flag, and the pool's queued builds are cancelled.
    """

    def __init__(
        self,
        dataset,
        collate: Callable,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        to_device: Callable | None = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if process_count > 1 and batch_size % process_count:
            raise ValueError(
                f"global batch_size={batch_size} not divisible by "
                f"process_count={process_count}")
        if not (0 <= process_index < max(1, process_count)):
            raise ValueError(f"process_index={process_index} out of range for "
                             f"process_count={process_count}")
        self.dataset = dataset
        self.collate = collate
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.to_device = to_device or (lambda b: b)
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.epoch = 0
        self.sample_weights: np.ndarray | None = None  # for curriculum reweighting

    @property
    def builders(self) -> int:
        """Threads building batches at once."""
        return max(self.prefetch, min(self.num_workers, 4))

    def __len__(self) -> int:
        n = len(self.dataset)
        n_batches = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        if self.process_count > 1 and not self.drop_last and n_batches:
            # a trailing partial global batch smaller than process_count rows
            # cannot give every process at least one row: it is dropped
            if n % self.batch_size and n % self.batch_size < self.process_count:
                n_batches -= 1
        return n_batches

    def _epoch_order(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed + self.epoch)
        n = len(self.dataset)
        if self.sample_weights is not None:
            p = np.asarray(self.sample_weights, np.float64)
            p = p / p.sum()
            return rng.choice(n, size=n, replace=True, p=p)
        order = np.arange(n)
        if self.shuffle:
            rng.shuffle(order)
        return order

    def _batch_indices(self) -> list[np.ndarray]:
        order = self._epoch_order()
        self.epoch += 1
        batch_idxs = [order[i * self.batch_size : (i + 1) * self.batch_size]
                      for i in range(len(self))]
        if self.process_count > 1:
            # this process's contiguous slice of each global batch; a ragged
            # final batch is cut to a size every process can take evenly
            local = []
            for idxs in batch_idxs:
                rows = len(idxs) // self.process_count
                local.append(idxs[self.process_index * rows : (self.process_index + 1) * rows])
            batch_idxs = local
        return batch_idxs

    def __iter__(self) -> Iterator[dict]:
        batch_idxs = self._batch_indices()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_until_stopped(item) -> bool:
            # a put that gives up once the consumer has stopped, so that an
            # abandoned epoch leaks no thread
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def build(idxs):
            return self.collate([self.dataset[int(i)] for i in idxs])

        def produce():
            # one builder thread per in-flight batch: the heavy per-item work
            # releases the GIL, so whole-batch builders run side by side
            pool = ThreadPoolExecutor(self.builders, thread_name_prefix=THREAD_PREFIX)
            try:
                it = iter(batch_idxs)
                pending = [pool.submit(build, idxs)
                           for idxs in (next(it, None) for _ in range(self.prefetch))
                           if idxs is not None]
                while pending and not stop.is_set():
                    batch = pending.pop(0).result()
                    idxs = next(it, None)
                    if idxs is not None:
                        pending.append(pool.submit(build, idxs))
                    if not put_until_stopped(batch):
                        return
            except Exception as exc:  # raised to the consumer by __iter__
                put_until_stopped(exc)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
                put_until_stopped(None)

        thread = threading.Thread(target=produce, name=f"{THREAD_PREFIX}-producer", daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield self.to_device(item)
        finally:
            stop.set()
