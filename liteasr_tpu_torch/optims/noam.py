"""Noam (inverse-sqrt warmup) schedule on Adam (liteasr_tpu/optims/noam.py):
``lr(step) = factor * d^-0.5 * min(step^-0.5, step * warmup^-1.5)`` with
step counting from 1, beta2=0.98, eps=1e-9, warmup=25000."""

from dataclasses import dataclass, field
from typing import Optional

import torch

from liteasr_tpu_torch.optims import LiteasrOptimizer, register_optimizer
from liteasr_tpu_torch.optims.adam import AdamConfig


@dataclass
class NoamConfig(AdamConfig):
    name: Optional[str] = field(default="noam")
    beta2: float = 0.98
    eps: float = 1e-9
    model_dim: int = 256
    factor: float = 1.0
    warmup: int = 25000


def noam_schedule(model_dim: int, factor: float, warmup: int):
    """count (int tensor of applied steps, 0-based) -> fp32 learning rate."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        s = torch.clamp(count + 1, min=1).float()
        return factor * model_dim ** (-0.5) * torch.minimum(
            s ** (-0.5), s * warmup ** (-1.5))

    return schedule


@register_optimizer("noam", dataclass=NoamConfig)
class Noam(LiteasrOptimizer):
    @classmethod
    def build_optimizer(cls, cfg, task=None):
        return cls(cfg, schedule=noam_schedule(cfg.model_dim, cfg.factor,
                                               cfg.warmup))
