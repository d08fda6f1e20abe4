"""Adam (liteasr_tpu/optims/adam.py; reference liteasr/optims/adam.py)."""

from dataclasses import dataclass, field
from typing import Optional

from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.optims import LiteasrOptimizer, register_optimizer


@dataclass
class AdamConfig(LiteasrDataclass):
    name: Optional[str] = field(default="adam")
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False


@register_optimizer("adam", dataclass=AdamConfig)
class Adam(LiteasrOptimizer):
    @classmethod
    def build_optimizer(cls, cfg, task=None):
        return cls(cfg, amsgrad=bool(cfg.amsgrad))
