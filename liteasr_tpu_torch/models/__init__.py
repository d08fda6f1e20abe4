"""Model registry (liteasr_tpu/models/__init__.py, torch side).

Models are ``torch.nn.Module``s that hold their parameters; ``build_model``
merges the registered dataclass defaults under the user config exactly as
the reference does, so one composed config builds either package's model.
"""

import torch

from liteasr_tpu_torch.registry import Registry, import_modules

_REGISTRY = Registry("model")
register_model = _REGISTRY.register


class LiteasrModel(torch.nn.Module):
    """Base model: subclasses implement the forward plus the length hooks."""

    def get_pred_len(self, xlens):
        raise NotImplementedError

    @classmethod
    def build_model(cls, cfg, task=None, device=None,
                    generator=None) -> "LiteasrModel":
        raise NotImplementedError


def build_model(cfg, task=None, device=None, generator=None) -> LiteasrModel:
    """Instantiate a model from the composed config, writing the completed
    tree back into ``cfg`` (reference liteasr/models/__init__.py:53-68)."""
    cls, cfg = _REGISTRY.resolve(cfg)
    return cls.build_model(cfg, task, device=device, generator=generator)


import_modules(__name__, __file__)
