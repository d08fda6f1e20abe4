"""Greedy minibatch assembly over a length-sorted index stream.

Capability parity with the reference policies (liteasr/utils/batchify.py:
12-182): indices arrive sorted descending by input length, and each policy
decides how many consecutive samples fit in one minibatch. Because of the
sort, every minibatch is nearly length-homogeneous — which is exactly what
the TPU's bucketed-padding pipeline wants (few distinct padded shapes,
minimal pad waste).

A policy contributes three hooks to the shared sweep in ``batchify``:

* ``open_batch(sample)``  -> stats for a batch starting with ``sample``
* ``admits(stats, sample)`` -> would ``sample`` still fit?
* ``absorb(stats, sample)`` -> account ``sample`` into ``stats``
"""

import logging
from typing import Dict, List

logger = logging.getLogger(__name__)


class BatchifyPolicy:
    def __init__(self, dataset_cfg):
        self.cfg = dataset_cfg
        self.data: List[List[int]] = []

    # -- policy hooks -------------------------------------------------
    def open_batch(self, sample) -> Dict:
        raise NotImplementedError

    def admits(self, stats: Dict, sample) -> bool:
        raise NotImplementedError

    def absorb(self, stats: Dict, sample) -> None:
        raise NotImplementedError

    # -- shared sweep -------------------------------------------------
    def batchify(self, indices, samples) -> None:
        if len(indices) != len(samples):
            raise ValueError(
                f"{len(indices)} indices for {len(samples)} samples")
        batch: List[int] = []
        stats: Dict = {}
        for idx in indices:
            sample = samples[idx]
            if batch and not self.admits(stats, sample):
                self.data.append(batch)
                batch = []
            if not batch:
                stats = self.open_batch(sample)
            else:
                self.absorb(stats, sample)
            batch.append(idx)
        if batch:
            self.data.append(batch)

    def __getitem__(self, index: int) -> List[int]:
        return self.data[index]

    def __len__(self) -> int:
        return len(self.data)


class SeqBatch(BatchifyPolicy):
    """Fixed sample count per batch, shrunk for long utterances.

    The first (longest) sample of a batch sets its capacity:
    ``batch_size / (1 + max(ilen // max_len_in, olen // max_len_out))``,
    floored at ``min_batch_size``
    (reference semantics: liteasr/utils/batchify.py:76-113).
    """

    def open_batch(self, sample):
        cfg = self.cfg
        shrink = max(int(sample.xlen / cfg.max_len_in),
                     int(sample.ylen / cfg.max_len_out))
        capacity = max(cfg.min_batch_size or 1,
                       int(cfg.batch_size / (1 + shrink)))
        return {"capacity": capacity, "count": 1}

    def admits(self, stats, sample):
        return stats["count"] < stats["capacity"]

    def absorb(self, stats, sample):
        stats["count"] += 1


class FrameBatch(BatchifyPolicy):
    """Caps total padded frames: max_len * count against each of
    ``max_frame_in`` / ``max_frame_out`` / ``max_frame_inout``
    (reference semantics: liteasr/utils/batchify.py:115-159)."""

    def open_batch(self, sample):
        return {"count": 1, "ilen": sample.xlen, "olen": sample.ylen}

    def admits(self, stats, sample):
        cfg = self.cfg
        ilen = max(stats["ilen"], sample.xlen)
        olen = max(stats["olen"], sample.ylen)
        count = stats["count"] + 1
        if cfg.max_frame_in and ilen * count > cfg.max_frame_in:
            return False
        if cfg.max_frame_out and olen * count > cfg.max_frame_out:
            return False
        if cfg.max_frame_inout and (ilen + olen) * count > cfg.max_frame_inout:
            return False
        return True

    def absorb(self, stats, sample):
        stats["count"] += 1
        stats["ilen"] = max(stats["ilen"], sample.xlen)
        stats["olen"] = max(stats["olen"], sample.ylen)


class Wav2VecBatch(BatchifyPolicy):
    """Raw-wave batches: crop-to-min times count stays under a sample
    budget (reference semantics: liteasr/utils/batchify.py:162-182)."""

    max_batch_frame: int = 1400000
    crop_frames: int = 250000

    def open_batch(self, sample):
        return {"count": 1,
                "min_frame": min(sample.xlen, self.crop_frames)}

    def admits(self, stats, sample):
        min_frame = min(stats["min_frame"], sample.xlen)
        return (stats["count"] + 1) * min_frame <= self.max_batch_frame

    def absorb(self, stats, sample):
        stats["count"] += 1
        stats["min_frame"] = min(stats["min_frame"], sample.xlen)
