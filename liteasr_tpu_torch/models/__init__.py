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
    """Base model: subclasses implement the forward plus the length hooks.

    Under sequence parallelism (``seq_parallel``, set by
    ``parallel.sharding.shard_model``) the encoder returns the rank's block
    of frames; a family's training forward joins the blocks
    (:meth:`gather_frames`) and runs its tail (the heads, the decoders, the
    joint, the predictor) on the rank's block of rows (:meth:`tail_rows`),
    so that the sp group splits the tail instead of repeating it."""

    seq_parallel = False

    def tail_rows(self, batch: int) -> slice:
        """The batch rows whose tail this rank runs: all of them, or under
        sequence parallelism the sp rank's block."""
        if not self.seq_parallel:
            return slice(None)
        from liteasr_tpu_torch.parallel import sharding

        seq = sharding.seq_shard(batch)
        return slice(seq.lo, seq.hi)

    def gather_frames(self, h_enc, t_sub: int):
        """Under sequence parallelism, the encoder output of every frame,
        (B, ``t_sub``, D): every sp rank's block ``h_enc`` joined over the
        group (with autograd: the backward keeps the rank's block's share of
        the group's gradients)."""
        from liteasr_tpu_torch.parallel import sharding

        return sharding.gather_from_sp(h_enc, 1, sharding.seq_shard(t_sub).sizes)

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
