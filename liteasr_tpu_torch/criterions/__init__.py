"""Criterion registry (liteasr_tpu/criterions/__init__.py, torch side).

A criterion calls the model itself and returns ``(scalar loss, aux)``;
``aux`` holds detached scalars for logging.

Under a process group each rank holds a row block of the global batch. The
loss and every aux scalar are then this rank's share: their sums over the
ranks are the values on the global batch (the denominators are all-reduced
counts, ``parallel.global_sum``), so that the optimizer's gradient
all-reduce sums the ranks' shares into the global batch's gradient. Without
a group the share is the whole.
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
