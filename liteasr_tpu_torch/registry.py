"""Named component registries for tasks, models, criterions and optimizers
(the register/build pattern of liteasr_tpu/{tasks,models,criterions,
optims}/__init__.py, one implementation for the four groups)."""

import importlib
import os
from typing import Dict, Optional

from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.config.core import ConfigStore, DotDict, _deep_merge, _node_to_dict


class Registry:
    def __init__(self, group: str):
        self.group = group
        self.classes: Dict[str, type] = {}
        self.dataclasses: Dict[str, type] = {}

    def register(self, name: str, dataclass: Optional[type] = None):
        """Class decorator: register ``cls`` under ``name``, and its config
        dataclass as the ``<group>/<name>`` config node."""
        def register_cls(cls):
            if name in self.classes:
                raise ValueError(f"duplicate {self.group} name {name}")
            self.classes[name] = cls
            if dataclass is not None:
                assert issubclass(dataclass, LiteasrDataclass)
                self.dataclasses[name] = dataclass
                ConfigStore.instance().store(name=name, node=dataclass,
                                             group=self.group)
            return cls

        return register_cls

    def resolve(self, cfg):
        """(class, cfg) for the component ``cfg.name`` names, with the
        registered dataclass defaults merged under ``cfg``; a dict ``cfg``
        is completed in place, as the reference does (liteasr/models/
        __init__.py:53-68)."""
        name = cfg.get("name") if isinstance(cfg, dict) else getattr(cfg, "name", None)
        if name is None or name not in self.classes:
            raise ValueError(f"unknown {self.group} '{name}' "
                             f"(known: {sorted(self.classes)})")
        dc = self.dataclasses.get(name)
        merged = dict(cfg) if isinstance(cfg, dict) else {}
        if dc is not None:
            merged = _deep_merge(_node_to_dict(dc), merged)
            merged["name"] = name
        if isinstance(cfg, dict):
            cfg.clear()
            cfg.update(merged)
            cfg = DotDict(cfg)
        return self.classes[name], cfg


def import_modules(package: str, init_file: str) -> None:
    """Import every public module of ``package`` so that they register."""
    for file in sorted(os.listdir(os.path.dirname(init_file))):
        if file.endswith(".py") and not file.startswith("_"):
            importlib.import_module(f"{package}.{file[:-len('.py')]}")
