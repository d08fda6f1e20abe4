"""Criterion registry (liteasr_tpu/criterions/__init__.py, torch side).

A criterion calls the model itself and returns ``(scalar loss, aux)``;
``aux`` holds detached scalars for logging.
"""

from liteasr_tpu_torch.registry import Registry, import_modules

_REGISTRY = Registry("criterion")
register_criterion = _REGISTRY.register


class LiteasrLoss:
    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, model, batch, train: bool = True):
        """Return (scalar loss tensor, aux dict)."""
        raise NotImplementedError

    @classmethod
    def build_criterion(cls, cfg, task=None):
        return cls(cfg, task)


def build_criterion(cfg, task=None) -> LiteasrLoss:
    cls, cfg = _REGISTRY.resolve(cfg)
    return cls.build_criterion(cfg, task)


import_modules(__name__, __file__)
