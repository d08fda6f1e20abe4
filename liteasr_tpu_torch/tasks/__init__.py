"""Task registry (liteasr_tpu/tasks/__init__.py, inference surface only)."""

import importlib
import os
from typing import Dict, Optional

from liteasr_tpu_torch import models
from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.config.core import ConfigStore, DotDict, _deep_merge, _node_to_dict

TASK_REGISTRY: Dict[str, type] = {}
TASK_DATACLASS_REGISTRY: Dict[str, type] = {}


class LiteasrTask:
    def __init__(self, cfg):
        self.cfg = cfg
        self.datasets = dict()

    def load_dataset(self, split, data_dir, dataset_cfg, postprocess_cfg,
                     memory_save: bool = False):
        raise NotImplementedError

    def dataset(self, split: str):
        return self.datasets[split]

    def build_model(self, cfg, device=None):
        return models.build_model(cfg, self, device=device)


def setup_task(cfg) -> LiteasrTask:
    name = cfg.get("name") if isinstance(cfg, dict) else getattr(cfg, "name", None)
    if name is None or name not in TASK_REGISTRY:
        raise ValueError(f"unknown task '{name}' (known: {sorted(TASK_REGISTRY)})")
    dc = TASK_DATACLASS_REGISTRY.get(name)
    merged = dict(cfg) if isinstance(cfg, dict) else {}
    if dc is not None:
        merged = _deep_merge(_node_to_dict(dc), merged)
        merged["name"] = name
    if isinstance(cfg, dict):
        cfg.clear()
        cfg.update(merged)
        cfg = DotDict(cfg)
    return TASK_REGISTRY[name](cfg)


def register_task(name: str, dataclass: Optional[type] = None):
    def register_task_cls(cls):
        if name in TASK_REGISTRY:
            raise ValueError(f"duplicate task name {name}")
        TASK_REGISTRY[name] = cls
        if dataclass is not None:
            assert issubclass(dataclass, LiteasrDataclass)
            TASK_DATACLASS_REGISTRY[name] = dataclass
            ConfigStore.instance().store(name=name, node=dataclass, group="task")
        return cls

    return register_task_cls


_dir = os.path.dirname(__file__)
for _file in sorted(os.listdir(_dir)):
    if _file.endswith(".py") and not _file.startswith("_"):
        importlib.import_module("liteasr_tpu_torch.tasks." + _file[: -len(".py")])
