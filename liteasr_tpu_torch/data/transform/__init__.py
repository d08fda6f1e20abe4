"""Post-process transform registry + pipeline.

Reference: liteasr/utils/transform/__init__.py:10-46 — transforms are
registered by name and applied in the config-ordered ``workflow``.
"""

import importlib
import os
from typing import Dict

TRANSFORMATION_REGISTRY: Dict[str, type] = {}


def register_transformation(name: str):
    def register_transformation_cls(cls):
        if name in TRANSFORMATION_REGISTRY:
            raise ValueError(f"duplicate transformation name {name}")
        TRANSFORMATION_REGISTRY[name] = cls
        return cls

    return register_transformation_cls


class PostProcess:
    """Config-ordered per-sample augmentation workflow (host side)."""

    def __init__(self, postprocess_cfg):
        from liteasr_tpu_torch.config.core import _wrap

        self.functions = []
        for process in postprocess_cfg.workflow:
            cls = TRANSFORMATION_REGISTRY[process]
            self.functions.append(cls(_wrap(postprocess_cfg[process])))

    def __call__(self, x):
        for fn in self.functions:
            x = fn(x)
        return x


_dir = os.path.dirname(__file__)
for _file in sorted(os.listdir(_dir)):
    if _file.endswith(".py") and not _file.startswith("_"):
        importlib.import_module(
            "liteasr_tpu_torch.data.transform." + _file[: -len(".py")])
