"""Conformer / Transformer encoder, full mode (liteasr_tpu/nets/encoder.py).

Conv2D subsample (T -> T') -> (relative) positional encoding -> N layers ->
final LayerNorm. The rel-pos table has the PADDED length T' of the batch,
as in the reference: the legacy rel_shift indexes it from its end.

``remat=True`` recomputes each layer's forward in the backward pass of a
train-mode call (``torch.utils.checkpoint``, liteasr_tpu/nets/encoder.py:
53-55, 170-190): the same result and gradients with less activation memory.
"""

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from liteasr_tpu_torch.nets.common import (
    LayerNorm, positional_encoding, relative_positional_encoding)
from liteasr_tpu_torch.nets.attention import RelativeMultiHeadAttention
from liteasr_tpu_torch.nets.layers import BatchNorm, ConformerLayer, EncoderLayer
from liteasr_tpu_torch.nets.subsampling import Conv2DSubsampling


def subsample_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) padding mask -> (B, T') after the two stride-2 convs
    (reference transformer_encoder.py:118)."""
    return mask[:, :-2:2][:, :-2:2]


@contextlib.contextmanager
def _recompute(layer: nn.Module):
    """The recompute of a rematerialized layer: its BatchNorms leave the
    running statistics alone (the first forward moved them; flax's remat
    drops the recompute's batch_stats update likewise)."""
    norms = [m for m in layer.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def remat_layer(layer: nn.Module, x, pos_emb, mask):
    """A train-mode layer call whose activations are recomputed in the
    backward pass. The global CPU/CUDA generators of the dropouts are
    replayed by ``checkpoint``; the rel-pos attention's kernel seed comes
    from the layer's own generator, which nothing replays, so it is drawn
    here, once, and handed to both the forward and the recompute."""
    seed = (layer.self_attn.draw_seed()
            if isinstance(layer.self_attn, RelativeMultiHeadAttention) else None)
    return checkpoint(layer, x, pos_emb, mask, True, seed, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute(layer)))


class TransformerEncoder(nn.Module):
    def __init__(self, input_dim: int, use_rel: bool, h_dim: int, ff_dim: int,
                 n_head: int, n_layer: int, activation: str = "swish",
                 arch: str = "conformer", conv_kernel: int = 15,
                 normalize_before: bool = True, dropout_rate: float = 0.0,
                 pos_dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0,
                 ff_dropout_rate: float = 0.0, remat: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if arch not in ("conformer", "transformer"):
            raise ValueError(f"unknown encoder arch {arch!r}")
        kw = dict(dtype=dtype, device=device)
        rates = (dropout_rate, attn_dropout_rate, ff_dropout_rate)
        self.remat = remat
        self.use_rel = use_rel
        self.n_layer = n_layer
        self.pos_dropout_rate = pos_dropout_rate
        self.embed = Conv2DSubsampling(input_dim, h_dim, **kw)
        for i in range(n_layer):
            if arch == "conformer":
                layer = ConformerLayer(h_dim, n_head, ff_dim, conv_kernel,
                                       activation, use_rel, normalize_before,
                                       *rates, **kw)
            else:
                layer = EncoderLayer(h_dim, n_head, ff_dim, activation,
                                     use_rel, normalize_before, *rates, **kw)
            self.add_module(f"layer_{i}", layer)
        self.after_norm = LayerNorm(h_dim, **kw)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                train: bool = False):
        """:param x: (B, T, F); ``mask``: (B, T) True = padding.
        Returns (B, T', h_dim)."""
        x = self.embed(x)
        if self.use_rel:
            x, pos_emb = relative_positional_encoding(
                x, self.pos_dropout_rate, train)
        else:
            x, pos_emb = positional_encoding(x, self.pos_dropout_rate,
                                             train), None
        attn_mask = None
        if mask is not None:
            attn_mask = subsample_mask(mask)[:, None, None, :]  # (B, 1, 1, T')
        for i in range(self.n_layer):
            layer = getattr(self, f"layer_{i}")
            if train and self.remat and torch.is_grad_enabled():
                x = remat_layer(layer, x, pos_emb, attn_mask)
            else:
                x = layer(x, pos_emb, attn_mask, train)
        return self.after_norm(x)
