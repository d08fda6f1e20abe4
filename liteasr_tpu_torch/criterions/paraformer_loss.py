"""Paraformer loss (liteasr_tpu/criterions/paraformer_loss.py): CE over the
non-ignored tokens (mean) + the MAE of the predicted token count
``sum_alpha`` against ``ylens`` over the real utterances.

The CE is taken from the raw logits as ``lse(h) - h[tgt]`` with the
logsumexp in fp32, so no log-softmax table is built.

The token and utterance counts are the global batch's: the dp rank's full
rows, summed over the dp group (tp and sp peers hold the same rows). Under
sequence parallelism the model returns the logits and token counts of its
``tail_rows`` only, and the CE and MAE take those rows, so that the ranks'
losses sum to the global one.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch

from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.config import MISSING, LiteasrDataclass
from liteasr_tpu_torch.criterions import LiteasrLoss, register_criterion


@dataclass
class ParaformerLossConfig(LiteasrDataclass):
    name: Optional[str] = field(default="paraformer_loss")
    vocab_size: int = MISSING
    gamma: float = 1.0


@register_criterion("paraformer_loss", dataclass=ParaformerLossConfig)
class ParaformerLoss(LiteasrLoss):
    def __init__(self, cfg, task=None):
        super().__init__(cfg)
        self.vocab_size = int(cfg.vocab_size)
        self.gamma = float(cfg.gamma)

    @classmethod
    def build_criterion(cls, cfg, task=None):
        if task is not None:
            cfg.vocab_size = task.vocab_size
        return cls(cfg, task)

    def __call__(self, model, batch, train: bool = True):
        """``batch["step"]``, when present, is the micro-step count that the
        model's glancing-ratio schedule reads. Returns (gamma * CE + MAE,
        {"loss_ce", "loss_mae"})."""
        xs, xlens, ys, ylens = (
            batch["xs"], batch["xlens"], batch["ys"], batch["ylens"])
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(xs.shape[0], device=xs.device)

        tgt = model.get_target(ys, ylens)  # (B, U), -1 ignored
        tgt = torch.where(valid[:, None] > 0, tgt, -1)
        # the global batch's token and utterance counts, in one all-reduce
        n_tok, nutt = parallel.global_sum((tgt != -1).sum(), valid.sum())

        hs_attn, sum_alpha = model(xs, xlens, ys, ylens, train=train,
                                   step=batch.get("step"))
        rows = model.tail_rows(xs.shape[0])
        tgt, ylens, valid = tgt[rows].reshape(-1), ylens[rows], valid[rows]
        ignore = tgt == -1
        h = hs_attn.reshape(-1, self.vocab_size)
        lse = torch.logsumexp(h.float(), dim=-1)
        h_tgt = h.gather(1, torch.where(ignore, 0, tgt).long()[:, None])[:, 0].float()
        loss_ce = torch.where(ignore, 0.0, lse - h_tgt).sum() / torch.clamp(n_tok, min=1)

        mae = (sum_alpha - ylens.float()).abs()
        loss_mae = (mae * valid).sum() / torch.clamp(nutt, min=1.0)

        loss = self.gamma * loss_ce + loss_mae
        return loss, {"loss_ce": loss_ce.detach(), "loss_mae": loss_mae.detach()}
