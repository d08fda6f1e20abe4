"""Hybrid CTC / label-smoothed attention loss
(liteasr_tpu/criterions/hybrid_ctc_attn.py).

The attention part is the full KL divergence ``true_dist * (log(true_dist)
- log_softmax(h))`` (torch KLDivLoss semantics, including the constant
entropy term), taken on the logits, summed over non-ignored positions and
divided by the number of real utterances; the CTC part is a summed NLL over
feasible real utterances divided by the same count; blended with
``ctc_weight``.

Under a process group the count is the global batch's, summed over the dp
group (tp and sp peers hold the same rows); under sequence parallelism the
model's forward returns the logits of its ``tail_rows`` only, and the loss
takes those rows, so that the ranks' losses sum to the global one.
"""

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.config import MISSING, LiteasrDataclass
from liteasr_tpu_torch.criterions import LiteasrLoss, register_criterion
from liteasr_tpu_torch.ops.ctc import ctc_loss_logits


@dataclass
class HybridCTCLossConfig(LiteasrDataclass):
    name: Optional[str] = field(default="hybrid_ctc")
    vocab_size: int = MISSING
    padding_idx: int = -1
    smoothing: float = 0.0
    normalize_length: bool = False
    ctc_weight: float = 0.0


def _xlogx(p: float) -> float:
    return p * math.log(p) if p > 0 else 0.0


def label_smoothed_kl(h_attn, tgt_attn, vocab_size: int, smoothing: float,
                      padding_idx: int = -1):
    """Sum over non-ignored positions of KL(true_dist || softmax(h)), from
    the logits: with logp_v = h_v - lse(h), sum_v logp_v = sum_v h_v - V lse
    and logp_tgt = h_tgt - lse (liteasr_tpu/criterions/hybrid_ctc_attn.py
    :32-66)."""
    tgt = tgt_attn.reshape(-1)
    ignore = tgt == padding_idx
    tgt_safe = torch.where(ignore, 0, tgt).long()
    h = h_attn.reshape(-1, vocab_size)
    hf = h.float()
    lse = torch.logsumexp(hf, dim=-1)
    sum_logp = hf.sum(dim=-1) - vocab_size * lse
    logp_tgt = h.gather(1, tgt_safe[:, None])[:, 0].float() - lse
    off = smoothing / (vocab_size - 1)
    on = 1.0 - smoothing
    ent = _xlogx(off) * (vocab_size - 1) + _xlogx(on)
    kl = ent - (off * sum_logp + (on - off) * logp_tgt)
    return torch.where(ignore, 0.0, kl).sum()


@register_criterion("hybrid_ctc", dataclass=HybridCTCLossConfig)
class HybridCTCLoss(LiteasrLoss):
    def __init__(self, cfg, task=None):
        super().__init__(cfg)
        self.vocab_size = int(cfg.vocab_size)
        self.smoothing = float(cfg.smoothing)
        self.ctc_weight = float(cfg.ctc_weight)
        self.padding_idx = int(cfg.padding_idx)

    @classmethod
    def build_criterion(cls, cfg, task=None):
        if task is not None:
            cfg.vocab_size = task.vocab_size
        return cls(cfg, task)

    def __call__(self, model, batch, train: bool = True):
        xs, xlens, ys, ylens = (
            batch["xs"], batch["xlens"], batch["ys"], batch["ylens"])
        valid = batch.get("valid")  # (B,) 1.0 for real utts, 0.0 for pad rows
        if valid is None:
            valid = torch.ones(xs.shape[0], device=xs.device)
        nutt = torch.clamp(parallel.global_sum(valid.sum()), min=1.0)  # global batch

        h_attn, h_ctc = model(xs, xlens, ys, ylens, train=train)
        rows = model.tail_rows(xs.shape[0])
        xlens, ys, ylens, valid = xlens[rows], ys[rows], ylens[rows], valid[rows]

        tgt_attn, _ = model.get_target(ys, ylens)
        # padded rows: every position ignored, so they contribute 0
        tgt_attn = torch.where(valid[:, None] > 0, tgt_attn, self.padding_idx)
        loss_attn = label_smoothed_kl(h_attn, tgt_attn, self.vocab_size,
                                      self.smoothing, self.padding_idx) / nutt

        tgt_ctc = torch.where(ys == self.padding_idx, 0, ys)
        pred_len = model.get_pred_len(xlens)
        per_utt = ctc_loss_logits(h_ctc, tgt_ctc, pred_len, ylens)
        # CTC needs pred_len >= ylen + repeated labels; an infeasible row is
        # weighted 0 (hybrid_ctc_attn.py:111-124)
        pos = torch.arange(ys.shape[1], device=ys.device)[None, :]
        repeats = ((tgt_ctc[:, 1:] == tgt_ctc[:, :-1])
                   & (pos[:, 1:] < ylens[:, None])).sum(dim=1)
        feasible = (pred_len >= ylens + repeats).float()
        loss_ctc = (per_utt * valid * feasible).sum() / nutt

        loss = self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_attn
        aux = {
            "loss_attn": loss_attn.detach(),
            "loss_ctc": loss_ctc.detach(),
            "ctc_infeasible": (valid * (1.0 - feasible)).sum(),
        }
        return loss, aux
