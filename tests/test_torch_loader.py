"""The port's EpochDataLoader and its ``pin_memory``: without it the same
batches, in the same order, as the JAX package's loader, each the
collator's own arrays; with it each batch also carries page-locked copies
of its arrays, the ids as int64, its numpy values untouched."""

import numpy as np
import torch

from liteasr_tpu.data.loader import EpochDataLoader
from liteasr_tpu_torch.data.loader import EpochDataLoader as PortLoader, PinnedBatch


class ArrayDataset:
    """Batches as the port's collators make them: a dict of fresh numpy
    arrays, float features and int32 ids, each collation recorded."""

    def __init__(self, n):
        self.items = list(range(n))
        self.collated = {}

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)

    def collator(self, item):
        rng = np.random.default_rng(item)
        batch = {"xs": rng.standard_normal((2, 5, 3)).astype(np.float32),
                 "xlens": rng.integers(1, 5, 2).astype(np.int32),
                 "ys": rng.integers(0, 9, (2, 4)).astype(np.int32),
                 "ylens": rng.integers(1, 4, 2).astype(np.int32),
                 "valid": np.ones(2, np.float32)}
        self.collated.setdefault(item, []).append(batch)
        return batch

    def collated_as(self, item, batch):
        """Whether ``batch`` holds the very arrays of a collation of ``item``."""
        return any(all(batch[k] is b[k] for k in b) and list(batch) == list(b)
                   for b in self.collated[item])


def _same_batch(a, b):
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_port_loader_without_pin_memory_yields_todays_batches():
    ds = ArrayDataset(7)
    loader = PortLoader(ds, shuffle=True, seed=11, num_workers=3, prefetch=2)
    assert loader.pin_memory is False
    it = iter(loader)
    got = [next(it) for _ in range(10)]  # past the first epoch's end
    order = list(loader._epoch_indices(0)) + list(loader._epoch_indices(1))[:3]
    assert loader.epoch == 1
    # plain dicts, the collator's own arrays, in the shuffled order
    for batch, idx in zip(got, order):
        assert type(batch) is dict
        assert ds.collated_as(idx, batch)
    # the same batches in the same order as the reference's loader
    ref = iter(EpochDataLoader(ArrayDataset(7), shuffle=True, seed=11, num_workers=3,
                               prefetch=2))
    for batch in got:
        _same_batch(batch, next(ref))


def test_port_loader_with_pin_memory_carries_the_ids_as_int64(monkeypatch):
    """The page-locked copies made beside the collator's arrays (here,
    without a card, by a stand-in for ``Tensor.pin_memory``)."""
    pinned_calls = []

    def pin(self):
        pinned_calls.append(tuple(self.shape))
        return self.clone()

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    ds = ArrayDataset(5)
    plain = list(PortLoader(ArrayDataset(5), seed=2, num_workers=2).epoch_iter(0))
    loader = PortLoader(ds, seed=2, num_workers=2, pin_memory=True)
    pinned = list(loader.epoch_iter(0))
    assert len(pinned_calls) == 5 * 5
    for batch, want, idx in zip(pinned, plain, loader._epoch_indices(0)):
        assert isinstance(batch, PinnedBatch)
        _same_batch(batch, want)  # the numpy values as collated
        assert ds.collated_as(idx, batch)
        assert list(batch.pinned) == list(batch)
        for key, t in batch.pinned.items():
            ids = key in ("ys", "xlens", "ylens")
            assert t.dtype == (torch.int64 if ids else torch.float32), key
            assert np.array_equal(t.numpy(), batch[key]), key
