"""Host-side batch iteration: shuffling and multi-threaded prefetch (a copy
of liteasr_tpu/data/loader.py, which is framework-free, with the spans of
``utils.tracing``: ``data.wait`` where the consumer blocks on a batch, and
``data.collate``, each batch's collation, stamped on its worker and
recorded by the consumer; and, with ``pin_memory``, a page-locked copy of
each batch made on its worker for ``trainer.to_device``).

Replaces the reference's DataLoader(batch_size=1) + DistributedSampler +
EpochDataLoader stack (liteasr/trainer.py:48-62, liteasr/utils/
data_loader.py:6-29). Per-host sharding deliberately does NOT happen here:
every host walks the identical shuffled batch order and the collator
materializes only its row shard (data/dataset.py collate_batch), which keeps
the global batch geometry in lockstep across processes. A worker pool
overlaps feature I/O + collation with device compute, preserving order.
"""

import itertools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from liteasr_tpu_torch.utils import tracing

ID_KEYS = ("ys", "xlens", "ylens")  # the batch's ids, which cross as int64


def host_tensor(key: str, val) -> torch.Tensor:
    """A batch value as the CPU tensor that crosses to the device: the
    numpy array's own memory, ids cast to int64."""
    t = torch.from_numpy(np.asarray(val))
    return t.long() if key in ID_KEYS else t


class PinnedBatch(dict):
    """A collated batch, its values the collator's own, that carries beside
    them ``pinned``: each value's :func:`host_tensor` in page-locked memory
    from torch's caching host allocator, which ``trainer.to_device`` copies
    from without waiting for the stream."""

    __slots__ = ("pinned",)


class EpochDataLoader:
    """Infinite iterator over a batchified dataset; bumps ``epoch`` when the
    underlying pass completes (reference utils/data_loader.py:6-29)."""

    def __init__(
        self,
        dataset,
        collate_fn: Optional[Callable] = None,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 1,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn or dataset.collator
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        self.pin_memory = pin_memory
        self.epoch = 0

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        return order

    def _load(self, idx: int):
        """The batch (a :class:`PinnedBatch` with ``pin_memory``), with its
        collation's ``time.time_ns()`` stamps, the page-locked copies
        included, and the worker's name (a profiler does not record on the
        workers)."""
        start = time.time_ns()
        batch = self.collate_fn(self.dataset[idx])
        if self.pin_memory:
            batch = PinnedBatch(batch)
            batch.pinned = {k: host_tensor(k, v).pin_memory() for k, v in batch.items()}
        return batch, start, time.time_ns(), threading.current_thread().name

    def epoch_iter(self, epoch: int) -> Iterator:
        """One in-order pass for a given epoch; up to ``num_workers``
        batches collate concurrently, ``prefetch`` extra queue ahead."""
        indices = iter(self._epoch_indices(epoch))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.num_workers + self.prefetch
            pending = deque(
                pool.submit(self._load, int(i))
                for i in itertools.islice(indices, window))
            while pending:
                with tracing.span("data.wait"):
                    batch, start, end, worker = pending.popleft().result()
                tracing.record("data.collate", start, end, thread=worker)
                nxt = next(indices, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, int(nxt)))
                yield batch

    def __iter__(self):
        while True:
            for batch in self.epoch_iter(self.epoch):
                yield batch
            self.epoch += 1

    def __len__(self):
        return len(self.dataset)
