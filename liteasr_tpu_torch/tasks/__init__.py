"""Task registry (liteasr_tpu/tasks/__init__.py)."""

import os

import torch

from liteasr_tpu_torch import criterions, models, optims
from liteasr_tpu_torch.registry import Registry, import_modules

_REGISTRY = Registry("task")
register_task = _REGISTRY.register


class LiteasrTask:
    def __init__(self, cfg):
        self.cfg = cfg
        self.datasets = dict()

    def load_dataset(self, split, data_dir, dataset_cfg, postprocess_cfg,
                     memory_save: bool = False):
        raise NotImplementedError

    def dataset(self, split: str):
        return self.datasets[split]

    def build_model(self, cfg, device=None, generator=None):
        return models.build_model(cfg, self, device=device, generator=generator)

    def build_optimizer(self, cfg):
        return optims.build_optimizer(cfg, self)

    def build_criterion(self, cfg):
        return criterions.build_criterion(cfg, self)

    def save_model(self, model_name: str, state_dict) -> str:
        """Write ``state_dict`` to ``<save_dir>/<model_name>``; returns the
        path."""
        path = os.path.join(self.save_dir, model_name)
        torch.save(state_dict, path)
        return path


def setup_task(cfg) -> LiteasrTask:
    cls, cfg = _REGISTRY.resolve(cfg)
    return cls(cfg)


import_modules(__name__, __file__)
