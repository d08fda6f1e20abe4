"""The port's ``Trainer.valid`` writes the criterion's scalar aux as the JAX
trainer does (liteasr_tpu/trainer.py:501-529): the mean of each over the
valid batches, `` | key: %.4f`` after ``valid loss: %.2f`` (keys sorted)
and ``round(v, 6)`` in the ``results_file`` row. Both trainers' ``valid``
run on the same per-batch numbers through stand-ins for the rest of the
trainer; then the port's train CLI, for U2 and the Paraformer, writes the
keys that the JAX criterion returns."""

import json
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu.config.core import DotDict as JaxDotDict

CPU = torch.device("cpu")
# each family's criterion aux (liteasr_tpu/criterions/*.py), "model_state"
# beside them in the JAX package
FAMILY_AUX = {"u2": ("loss_attn", "loss_ctc", "ctc_infeasible"),
              "paraformer": ("loss_ce", "loss_mae"),
              "wav2vec2": ("accuracy", "code_ppl"),
              "transducer": ()}
VALID_RE = re.compile(r"valid loss: .*$")


class _Batches:
    """A valid set of ``n`` one-row batches."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return [idx]

    def collator(self, items):
        return {"xs": np.zeros((1, 4), np.float32)}


class _Stand:
    """What ``valid`` reads of a trainer besides its own body."""

    iter, max_iter, epoch, max_epoch, state, mesh = 7, "inf", 2, 3, None, None
    device = CPU

    def __init__(self, n):
        self.valid_set = _Batches(n)
        self.rows = []
        self._results_append = self.rows.append


def _valid_line(caplog, name):
    (msg,) = [r.getMessage() for r in caplog.records
              if r.name == name and "valid loss:" in r.getMessage()]
    return VALID_RE.search(msg).group(0)


@pytest.mark.parametrize("family", sorted(FAMILY_AUX))
def test_valid_writes_aux_as_the_jax_trainer(family, caplog, monkeypatch):
    import liteasr_tpu.trainer as jtrainer
    from liteasr_tpu_torch.trainer import Trainer

    # multiples of 1/64, so that any summation order gives the same mean
    rng = np.random.default_rng(sorted(FAMILY_AUX).index(family))
    per_batch = [(np.float32(rng.integers(0, 320) / 64),
                  {k: np.float32(rng.integers(0, 6400) / 64) for k in FAMILY_AUX[family]})
                 for _ in range(3)]

    jax_stand, calls = _Stand(3), iter(per_batch)

    def jax_eval_step(state, batch):  # the filtered extras of its eval_step
        loss, aux = next(calls)
        return jnp.asarray(loss), {k: jnp.asarray(v) for k, v in aux.items()}

    jax_stand._eval_step = jax_eval_step
    monkeypatch.setattr(jtrainer, "shard_batch", lambda mesh, batch: batch)
    port_stand, port_calls = _Stand(3), iter(per_batch)

    def port_eval_step(batch):  # the criterion's aux, non-scalars included
        loss, aux = next(port_calls)
        return torch.tensor(loss), {**{k: torch.tensor(v) for k, v in aux.items()},
                                    "model_state": {}, "hyps": torch.zeros(2)}

    port_stand.eval_step = port_eval_step
    with caplog.at_level(logging.INFO):
        jtrainer.Trainer.valid(jax_stand)
        Trainer.valid(port_stand)
    port_line = _valid_line(caplog, "liteasr_tpu_torch.trainer")
    assert port_line == _valid_line(caplog, "liteasr_tpu.trainer")
    assert port_stand.rows == jax_stand.rows
    assert re.findall(r"\| (\w+):", port_line) == sorted(FAMILY_AUX[family])
    assert set(port_stand.rows[0]) == {"kind", "iter", "epoch", "valid_loss",
                                       *FAMILY_AUX[family]}


def _jax_u2_aux_keys():
    from liteasr_tpu.criterions.hybrid_ctc_attn import HybridCTCLoss as JaxLoss
    from test_torch_train import _batch, _cfg
    from test_torch_u2 import build_pair

    jmodel, variables, _ = build_pair(5)
    jcrit = JaxLoss(JaxDotDict(_cfg()))
    _, aux = jax.jit(lambda v, b: jcrit(jmodel, v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in _batch(5).items()})
    return aux


def _jax_paraformer_aux_keys():
    from liteasr_tpu.criterions.paraformer_loss import ParaformerLoss as JaxLoss
    from test_torch_paraformer import TINY, build_pair, para_batch

    jmodel, variables, _ = build_pair(4)
    jcrit = JaxLoss(JaxDotDict(vocab_size=TINY["vocab_size"], gamma=1.0))
    _, aux = jax.jit(lambda v, b: jcrit(jmodel, v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in para_batch(4).items()})
    return aux


@pytest.mark.parametrize("family", ["u2", "paraformer"])
def test_train_cli_valid_carries_the_jax_criterion_aux(family, tiny_corpus, tmp_path):
    """One epoch of the port's train CLI: its ``valid loss:`` line and its
    results row carry exactly the scalar aux keys the JAX criterion returns
    at eval (what JAX's eval_step keeps)."""
    from liteasr_tpu_torch import train
    from test_torch_paraformer_cli import _port_overrides
    from test_torch_train import _train_overrides

    if family == "u2":
        overrides, aux = _train_overrides(tiny_corpus, tmp_path), _jax_u2_aux_keys()
    else:
        overrides = _port_overrides(tiny_corpus, tmp_path) + [
            "optimization.max_epoch=1", f"common.results_file={tmp_path / 'results.jsonl'}"]
        aux = _jax_paraformer_aux_keys()
    keys = sorted(k for k, v in aux.items() if k != "model_state" and jnp.ndim(v) == 0)
    assert keys == sorted(FAMILY_AUX[family])
    train.main(overrides, device=CPU)
    (line,) = [ln for ln in (tmp_path / "train.log").read_text().splitlines()
               if "valid loss:" in ln]
    assert re.findall(r"\| (\w+): -?\d+\.\d{4}(?= \||$)", line) == keys
    rows = [json.loads(r) for r in (tmp_path / "results.jsonl").read_text().splitlines()]
    (row,) = [r for r in rows if r["kind"] == "valid"]
    assert set(row) == {"ts", "kind", "iter", "epoch", "valid_loss", *keys}
