"""Model registry (liteasr_tpu/models/__init__.py, torch side).

Models are ``torch.nn.Module``s that hold their parameters; ``build_model``
merges the registered dataclass defaults under the user config exactly as
the reference does, so one composed config builds either package's model.
"""

import importlib
import os
from typing import Dict, Optional

import torch

from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.config.core import ConfigStore, DotDict, _deep_merge, _node_to_dict

MODEL_REGISTRY: Dict[str, type] = {}
MODEL_DATACLASS_REGISTRY: Dict[str, type] = {}


class LiteasrModel(torch.nn.Module):
    """Base model: subclasses implement the forward plus the length hooks."""

    def get_pred_len(self, xlens):
        raise NotImplementedError

    @classmethod
    def build_model(cls, cfg, task=None, device=None) -> "LiteasrModel":
        raise NotImplementedError


def register_model(name: str, dataclass: Optional[type] = None):
    def register_model_cls(cls):
        if name in MODEL_REGISTRY:
            raise ValueError(f"duplicate model name {name}")
        MODEL_REGISTRY[name] = cls
        if dataclass is not None:
            assert issubclass(dataclass, LiteasrDataclass)
            MODEL_DATACLASS_REGISTRY[name] = dataclass
            ConfigStore.instance().store(name=name, node=dataclass, group="model")
        cls.__dataclass__ = dataclass
        return cls

    return register_model_cls


def build_model(cfg, task=None, device=None) -> LiteasrModel:
    """Instantiate a model from the composed config, writing the completed
    tree back into ``cfg`` (reference liteasr/models/__init__.py:53-68)."""
    name = cfg.get("name") if isinstance(cfg, dict) else getattr(cfg, "name", None)
    if name is None or name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model '{name}' (known: {sorted(MODEL_REGISTRY)})")
    dc = MODEL_DATACLASS_REGISTRY.get(name)
    merged = dict(cfg) if isinstance(cfg, dict) else {}
    if dc is not None:
        merged = _deep_merge(_node_to_dict(dc), merged)
        merged["name"] = name
    if isinstance(cfg, dict):
        cfg.clear()
        cfg.update(merged)
        cfg = DotDict(cfg)
    return MODEL_REGISTRY[name].build_model(cfg, task, device=device)


_models_dir = os.path.dirname(__file__)
for _file in sorted(os.listdir(_models_dir)):
    if _file.endswith(".py") and not _file.startswith("_"):
        importlib.import_module("liteasr_tpu_torch.models." + _file[: -len(".py")])
