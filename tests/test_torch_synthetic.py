"""The port's synthetic task (liteasr_tpu_torch/tasks/synthetic.py) against
the JAX package's: the same global batch bit for bit for several (seed,
index) and shardings, and row shards that concatenate to the global batch
(as tests/test_multihost_lockstep.py holds the real collator)."""

import numpy as np
import pytest

from liteasr_tpu.config.core import DotDict as JaxDotDict


def _datasets(split, **cfg):
    from liteasr_tpu.tasks.synthetic import SyntheticTask as JaxTask
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.tasks.synthetic import SyntheticTask

    base = dict(train="", valid="", train_batches=3, valid_batches=2, batch_size=6,
                time=20, feat_dim=5, label_len=7, vocab_size=11, data_seed=0,
                save_dir=cfg.pop("save_dir"))
    base.update(cfg)
    out = []
    for task in (JaxTask(JaxDotDict(base)), SyntheticTask(DotDict(base))):
        task.load_dataset(split)
        out.append(task.dataset(split))
    return out


@pytest.mark.parametrize("split,seed,multiple,shards", [
    ("train", 0, 1, 1), ("train", 7, 8, 1), ("valid", 3, 1, 4), ("train", 11, 2, 2)])
def test_batches_equal_jax_bit_for_bit(tmp_path, split, seed, multiple, shards):
    jax_ds, port_ds = _datasets(split, data_seed=seed, save_dir=str(tmp_path))
    assert len(jax_ds) == len(port_ds)
    for shard in range(shards):
        for ds in (jax_ds, port_ds):
            ds.batch_multiple, ds.num_shards, ds.shard_index = multiple, shards, shard
        for index in range(len(port_ds)):
            ref = jax_ds.collator(jax_ds[index])
            got = port_ds.collator(port_ds[index])
            assert set(got) == set(ref)
            for key in ref:
                assert got[key].dtype == ref[key].dtype, key
                np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_shards_concatenate_to_the_global_batch(tmp_path):
    """6 rows over 4 shards: the global batch pads to 8 (batch_multiple 1 x
    num_shards 4), and the shards' rows are its rows in order."""
    _, ds = _datasets("train", save_dir=str(tmp_path))
    ds.batch_multiple, ds.num_shards = 1, 4
    shards = []
    for shard in range(4):
        ds.shard_index = shard
        shards.append(ds.collator(1))
    ds.num_shards, ds.batch_multiple, ds.shard_index = 1, 4, 0
    full = ds.collator(1)
    assert full["xs"].shape == (8, 20, 5)
    for key in full:
        np.testing.assert_array_equal(np.concatenate([s[key] for s in shards]),
                                      full[key], err_msg=key)
    assert {s["xs"].shape for s in shards} == {(2, 20, 5)}
