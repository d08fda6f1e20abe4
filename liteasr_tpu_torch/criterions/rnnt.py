"""RNN-T criterion (liteasr_tpu/criterions/rnnt.py).

The lattice DP of :mod:`liteasr_tpu_torch.ops.rnnt`, reduced to the mean
over the batch's real utterances (``valid``), as the warp libraries'
default batch mean.

The count is the global batch's, summed over the dp group (tp and sp peers
hold the same rows); under sequence parallelism the model's lattice is of
its ``tail_rows`` only, and the per-utterance losses take those rows, so
that the ranks' losses sum to the global one.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch

from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.criterions import LiteasrLoss, register_criterion
from liteasr_tpu_torch.ops.rnnt import rnnt_loss


@dataclass
class RNNTLossConfig(LiteasrDataclass):
    name: Optional[str] = field(default="rnnt")
    trans_type: str = "tpu-lattice"  # kept for config-surface parity
    blank_id: int = 0


@register_criterion("rnnt", dataclass=RNNTLossConfig)
class RNNTLoss(LiteasrLoss):
    def __init__(self, cfg, task=None):
        super().__init__(cfg)
        self.blank_id = int(cfg.blank_id)

    def __call__(self, model, batch, train: bool = True):
        xs, xlens, ys, ylens = (
            batch["xs"], batch["xlens"], batch["ys"], batch["ylens"])
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(xs.shape[0], device=xs.device)
        nutt = torch.clamp(parallel.global_sum(valid.sum()), min=1.0)  # global batch

        logits = model(xs, xlens, ys, ylens, train=train)
        rows = model.tail_rows(xs.shape[0])
        xlens, ys, ylens, valid = xlens[rows], ys[rows], ylens[rows], valid[rows]
        per_utt = rnnt_loss(logits, model.get_target(ys, ylens),
                            model.get_pred_len(xlens), model.get_target_len(ylens),
                            blank=self.blank_id)
        return (per_utt * valid).sum() / nutt, {}
