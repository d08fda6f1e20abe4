"""Host-side batch iteration: shuffling and multi-threaded prefetch (a copy
of liteasr_tpu/data/loader.py, which is framework-free).

Replaces the reference's DataLoader(batch_size=1) + DistributedSampler +
EpochDataLoader stack (liteasr/trainer.py:48-62, liteasr/utils/
data_loader.py:6-29). Per-host sharding deliberately does NOT happen here:
every host walks the identical shuffled batch order and the collator
materializes only its row shard (data/dataset.py collate_batch), which keeps
the global batch geometry in lockstep across processes. A worker pool
overlaps feature I/O + collation with device compute, preserving order.
"""

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np


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
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn or dataset.collator
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        return order

    def _load(self, idx: int):
        return self.collate_fn(self.dataset[idx])

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
                batch = pending.popleft().result()
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
