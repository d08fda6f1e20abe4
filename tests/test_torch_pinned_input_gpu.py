"""The page-locked path of the port's data input on the card, without JAX
(``python -m pytest --noconftest -m gpu tests/test_torch_pinned_input_gpu.py``).

With the stream held by a ~200 ms sleep, eight batches of an
``EpochDataLoader`` with ``pin_memory`` go through ``trainer.to_device``
under a profiler: each call returns in under 5 ms of host time, and the
sleep still runs when the last has returned. Each batch is dropped once
copied, so its page-locked blocks go back to the caching host allocator
while their copies wait. After a synchronize every device tensor equals
the pageable path's bit for bit, ids as int64: no block was handed to a
later batch before its copy had run. The counters read every byte as
page-locked.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from liteasr_tpu_torch.data.loader import EpochDataLoader, PinnedBatch
from liteasr_tpu_torch.trainer import to_device
from liteasr_tpu_torch.utils import tracing

ROWS, FRAMES, FEAT, LABELS = 8, 1024, 80, 48  # 2.6 MB of features a batch
BATCHES = 8
HOLD_MS = 200.0
CALL_MS = 5.0
IDS = ("ys", "xlens", "ylens")


class Batches:
    """Batches of one shape and distinct values, so that the caching host
    allocator could hand a freed block to any later batch. The values are
    drawn once; each collation copies them into fresh arrays, as a
    collator does."""

    def __init__(self, n):
        self.items = []
        for i in range(n):
            rng = np.random.default_rng(i)
            self.items.append({
                "xs": rng.standard_normal((ROWS, FRAMES, FEAT), dtype=np.float32),
                "xlens": rng.integers(1, FRAMES, ROWS).astype(np.int32),
                "ys": rng.integers(0, 4233, (ROWS, LABELS)).astype(np.int32),
                "ylens": rng.integers(1, LABELS, ROWS).astype(np.int32),
                "valid": np.ones(ROWS, np.float32)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return i

    def collator(self, i):
        return {k: v.copy() for k, v in self.items[i].items()}


def _bytes(batch):
    return sum(v.size * (8 if k in IDS else v.itemsize) for k, v in batch.items())


def _sleep_cycles(dev, ms):
    """The ``torch.cuda._sleep`` cycles that hold the stream ``ms``."""
    torch.cuda._sleep(1_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return int(ms * 20_000_000 / start.elapsed_time(end))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: page-locked memory and a stream to hold")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_pinned_batches_cross_without_holding_the_host(cuda):
    data = Batches(BATCHES)
    # warm both allocators with as many batches alive as the timed pass keeps
    warm = EpochDataLoader(data, shuffle=False, num_workers=2, pin_memory=True)
    held = [(b, to_device(b, cuda)) for b in warm.epoch_iter(0)]
    torch.cuda.synchronize(cuda)
    del held
    cycles = _sleep_cycles(cuda, HOLD_MS)

    loader = EpochDataLoader(data, shuffle=True, seed=5, num_workers=2, pin_memory=True)
    order = [int(i) for i in loader._epoch_indices(0)]
    tracing.reset()
    calls_ms, copied, pinned_bytes = [], [], 0
    stream = torch.cuda.current_stream(cuda)
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda._sleep(cycles)
        for batch in loader.epoch_iter(0):
            assert isinstance(batch, PinnedBatch)
            assert all(t.is_pinned() for t in batch.pinned.values())
            t0 = time.perf_counter()
            on_device = to_device(batch, cuda)
            calls_ms.append(1e3 * (time.perf_counter() - t0))
            copied.append(on_device)
            pinned_bytes += _bytes(batch)
            del batch  # its blocks go back to the allocator while the copy waits
        still_held = not stream.query()
    torch.cuda.synchronize(cuda)

    assert len(copied) == BATCHES
    assert max(calls_ms) < CALL_MS, calls_ms
    assert still_held, "the sleep ended before the last copy was queued"
    totals = tracing.totals()
    assert totals["data.h2d_pinned_bytes"] == {"count": BATCHES, "total": pinned_bytes}
    assert totals["data.h2d_pageable_bytes"] == {"count": BATCHES, "total": 0}

    for idx, on_device in zip(order, copied):
        want = to_device(data.collator(idx), cuda)  # the pageable path
        assert list(on_device) == list(want)
        for key, t in on_device.items():
            assert t.device == cuda and t.dtype == want[key].dtype, key
            assert t.dtype == (torch.int64 if key in IDS else torch.float32), key
            assert torch.equal(t, want[key]), (idx, key)
