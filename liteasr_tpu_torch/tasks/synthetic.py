"""Synthetic in-memory ASR task (liteasr_tpu/tasks/synthetic.py).

Feeds the Trainer deterministic random batches with no disk I/O: every
process derives the same global batch from (seed, index) and keeps only its
row shard, as ``collate_batch`` does for a real corpus. The draws are the
JAX task's, in the same order, so both packages see the same batches bit
for bit.
"""

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.tasks import LiteasrTask, register_task
from liteasr_tpu_torch.utils.misc import round_up


class SyntheticBatchDataset:
    """Dataset whose items collate into deterministic fixed-shape batches."""

    def __init__(self, n_batches: int, batch_size: int, time: int,
                 feat_dim: int, label_len: int, vocab_size: int, seed: int):
        self.n_batches = n_batches
        self.batch_size = batch_size
        self.time = time
        self.feat_dim = feat_dim
        self.label_len = label_len
        self.vocab_size = vocab_size
        self.seed = seed
        # the trainer sets these (as for AudioFileDataset)
        self.batch_multiple = 1
        self.num_shards = 1
        self.shard_index = 0

    def __len__(self) -> int:
        return self.n_batches

    def __getitem__(self, index: int) -> int:
        return index  # the item is the batch index; the collator renders it

    def collator(self, index: int):
        """Batch ``index``: the same global batch on every process, this
        process's row shard of it."""
        rng = np.random.default_rng((self.seed, index))
        B = round_up(self.batch_size, self.batch_multiple * self.num_shards)
        T, D, U = self.time, self.feat_dim, self.label_len
        xs = rng.normal(size=(B, T, D)).astype(np.float32)
        xlens = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
        ys = rng.integers(1, self.vocab_size - 1, size=(B, U)).astype(np.int32)
        ylens = rng.integers(max(U // 2, 1), U + 1, size=B).astype(np.int32)
        valid = np.ones(B, dtype=np.float32)

        rows = B // self.num_shards
        sl = slice(self.shard_index * rows, (self.shard_index + 1) * rows)
        return {"xs": xs[sl], "xlens": xlens[sl], "ys": ys[sl],
                "ylens": ylens[sl], "valid": valid[sl]}


@dataclass
class SyntheticConfig(LiteasrDataclass):
    # unused path placeholders, so that the train CLI's load_dataset calls work
    train: str = ""
    valid: str = ""
    train_batches: int = 8
    valid_batches: int = 2
    batch_size: int = 8
    time: int = 64
    feat_dim: int = 16
    label_len: int = 8
    vocab_size: int = 32
    data_seed: int = 0
    save_dir: str = "ckpts"


@register_task("synthetic", dataclass=SyntheticConfig)
class SyntheticTask(LiteasrTask):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.vocab_size = cfg.vocab_size
        self.feat_dim = cfg.feat_dim
        self.save_dir = cfg.save_dir
        os.makedirs(self.save_dir, exist_ok=True)

    def load_dataset(self, split, data_dir=None, dataset_cfg=None,
                     postprocess_cfg=None, memory_save: bool = False):
        cfg = self.cfg
        n = cfg.train_batches if split == "train" else cfg.valid_batches
        self.datasets[split] = SyntheticBatchDataset(
            n_batches=n, batch_size=cfg.batch_size, time=cfg.time,
            feat_dim=cfg.feat_dim, label_len=cfg.label_len,
            vocab_size=cfg.vocab_size,
            seed=cfg.data_seed + (0 if split == "train" else 10 ** 6))

    def inference(self, x, model) -> Optional[str]:
        return None  # nothing meaningful to decode on random features
