"""wav2vec 2.0 contrastive loss (liteasr_tpu/criterions/wav2vec_loss.py).

CE over the N+1 candidates with the positive at 0, weighted by the masked
valid frames and the real utterances (``valid``), plus, with
``diversity_weight``, the codebook diversity term ``(GV - sum of the
groups' perplexities) / GV``. The Gumbel temperature anneals from
``batch["step"]`` (the micro-steps taken): ``max(start * decay^step,
end)`` in fp32.

Under a process group the code usage is the global batch's (the quantizer
all-reduces it over the dp x sp ranks, which hold the shares of the rows
and frames), so every rank computes the same perplexities; each of the W =
dp x sp ranks of its tp slice adds 1/W of the diversity term and reports
1/W of ``code_ppl``, so that the sums over the dp x sp group count them
once (tp peers hold the whole term alike, as they hold the whole loss). The
all-reduce's backward sums the ranks' 1/W gradients of the one global term,
which gives every rank's inputs the gradient of the whole term. The CE's
and the accuracy's denominator, the masked frames, is the dp x sp group's
sum.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch

from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.criterions import LiteasrLoss, register_criterion
from liteasr_tpu_torch.nets.wav2vec2 import wide_float


@dataclass
class Wav2Vec2LossConfig(LiteasrDataclass):
    name: Optional[str] = field(default="wav2vec")
    infonce: bool = False
    # fairseq's prob_perplexity penalty; 0.0 is the reference's plain CE
    diversity_weight: float = 0.0


def gumbel_temperature(latent_temp, step) -> torch.Tensor:
    """The fp32 temperature at ``step`` micro-steps (liteasr_tpu/criterions/
    wav2vec_loss.py:56-64)."""
    start, end, decay = latent_temp
    power = torch.pow(torch.tensor(decay, dtype=torch.float32),
                      torch.as_tensor(step).float().cpu())
    return torch.clamp(start * power, min=end)


def term_shares() -> int:
    """The ranks that each add 1/W of a batch-global term (the diversity
    term, ``code_ppl``): the W = dp x sp ranks of a tp slice."""
    lay = parallel.layout()
    return lay.dp * lay.sp


@register_criterion("wav2vec", dataclass=Wav2Vec2LossConfig)
class Wav2Vec2Loss(LiteasrLoss):
    def __init__(self, cfg, task=None):
        super().__init__(cfg)
        self.diversity_weight = float(cfg.get("diversity_weight", 0.0))

    def __call__(self, model, batch, train: bool = True):
        """Returns (loss, {"accuracy", "code_ppl"}), both detached scalars."""
        xs = batch["xs"]  # (B, T) raw waveform
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(xs.shape[0], device=xs.device)
        step = batch.get("step")
        temp = (model.latent_temp[0] if step is None
                else gumbel_temperature(model.latent_temp, step))

        logits, mask, code_probs = model(xs, batch.get("xlens"), train=train, temp=temp)

        wide = wide_float(logits.dtype)
        nll = -torch.log_softmax(logits.to(wide), dim=0)[0]  # (B, F)
        weight = mask.to(wide) * valid[:, None].to(wide)
        # the global batch's masked frames
        denom = torch.clamp(parallel.global_sum(weight.sum(), over="dpsp"), min=1.0)
        loss = (nll * weight).sum() / denom

        code_probs = code_probs.to(wide)
        ppl = torch.exp(-torch.sum(code_probs * torch.log(code_probs + 1e-9), dim=-1))
        n_codes = code_probs.shape[0] * code_probs.shape[1]
        world = term_shares()
        if self.diversity_weight:
            diversity = self.diversity_weight * (n_codes - ppl.sum()) / n_codes
            loss = loss + (diversity if world == 1 else diversity / world)

        correct = (torch.argmax(logits, dim=0) == 0).to(wide)
        acc = (correct * weight).sum() / denom
        code_ppl = ppl.sum().detach()
        return loss, {"accuracy": acc.detach(),
                      "code_ppl": code_ppl if world == 1 else code_ppl / world}
