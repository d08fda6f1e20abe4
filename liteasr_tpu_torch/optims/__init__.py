"""Optimizer registry (liteasr_tpu/optims/__init__.py, torch side).

An optimizer here is its config plus an optional learning-rate schedule;
the update itself is the one fused path of :mod:`.fused_step`
(``FusedAdam``), which ``build_tx`` builds over a model's parameters.
"""

from liteasr_tpu_torch.registry import Registry, import_modules

_REGISTRY = Registry("optimizer")
register_optimizer = _REGISTRY.register


class LiteasrOptimizer:
    """An optimizer config and its schedule: ``schedule(count)`` maps the
    (tensor) count of applied steps to the learning rate; None = ``lr``.
    ``amsgrad``: the update divides by the running max of the corrected
    second moment."""

    def __init__(self, cfg, schedule=None, amsgrad: bool = False):
        self.cfg = cfg
        self.schedule = schedule
        self.amsgrad = bool(amsgrad)

    @classmethod
    def build_optimizer(cls, cfg, task=None):
        raise NotImplementedError


def build_optimizer(cfg, task=None) -> LiteasrOptimizer:
    cls, cfg = _REGISTRY.resolve(cfg)
    return cls.build_optimizer(cfg, task)


import_modules(__name__, __file__)
