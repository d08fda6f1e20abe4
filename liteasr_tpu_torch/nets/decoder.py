"""Transformer decoder (liteasr_tpu/nets/decoder.py).

embed -> PE -> N DecoderLayers (self + src attention) -> LayerNorm ->
vocab projection. ``forward`` is full mode; ``prime`` and ``step`` are the
KV-cached decode of the attention beam search (``mode="prime"`` /
``"step"``, liteasr_tpu/nets/decoder.py:65-84).
"""

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.nets.common import (
    Dense, LayerNorm, positional_encoding, sinusoidal_pe_at)
from liteasr_tpu_torch.nets.encoder import subsample_mask
from liteasr_tpu_torch.nets.layers import DecoderLayer


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, h_dim: int, ff_dim: int, n_head: int,
                 n_layer: int, normalize_before: bool = True,
                 dropout_rate: float = 0.0, pos_dropout_rate: float = 0.0,
                 self_attn_dropout_rate: float = 0.0,
                 src_attn_dropout_rate: float = 0.0,
                 ff_dropout_rate: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.compute_dtype = dtype
        self.n_layer = n_layer
        self.pos_dropout_rate = pos_dropout_rate
        self.embed = nn.Embedding(vocab_size, h_dim, device=device,
                                  dtype=torch.float32)
        for i in range(n_layer):
            self.add_module(f"layer_{i}", DecoderLayer(
                h_dim, n_head, ff_dim, normalize_before, dropout_rate,
                self_attn_dropout_rate, src_attn_dropout_rate,
                ff_dropout_rate, **kw))
        self.after_norm = LayerNorm(h_dim, **kw)
        self.linear_out = Dense(h_dim, vocab_size, **kw)

    def forward(self, y, memory, mask: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                memory_mask_presubsampled: bool = False, train: bool = False):
        """:param y: (B, L) token ids; ``memory``: (B, T', D)
        :param mask: (B, L, L) self-attention mask (True = masked)
        :param memory_mask: (B, T) padding mask, subsampled here — or
            already (B, T') if ``memory_mask_presubsampled``
        """
        dt = self.compute_dtype
        y = positional_encoding(F.embedding(y, self.embed.weight.to(dt)),
                                self.pos_dropout_rate, train)
        if mask is not None:
            mask = mask[:, None, :, :]  # (B, 1, L, L)
        if memory_mask is not None:
            if not memory_mask_presubsampled:
                memory_mask = subsample_mask(memory_mask)
            memory_mask = memory_mask[:, None, None, :]  # (B, 1, 1, T')
        for i in range(self.n_layer):
            y = getattr(self, f"layer_{i}")(y, memory, mask, memory_mask,
                                            train)
        return self.linear_out(self.after_norm(y))

    def prime(self, memory) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's source K/V of ``memory`` (B, T', D), each
        (B, T', H, Dk), projected once."""
        return [getattr(self, f"layer_{i}").src_attn.prime_kv(memory)
                for i in range(self.n_layer)]

    def step(self, tok, src_kv, self_caches, index: int,
             memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step: ``tok`` (B,) ids at position ``index``;
        ``self_caches`` a per-layer list of (k, v), each (B, L, H, Dk),
        written in place at ``index``; ``memory_mask`` (B, 1, 1, T') or None.
        Returns the logits (B, V)."""
        dt = self.compute_dtype
        y = F.embedding(tok[:, None], self.embed.weight.to(dt))  # (B, 1, D)
        d = y.shape[-1]
        y = y * math.sqrt(d) + sinusoidal_pe_at(index, d, y.dtype, y.device)
        for i in range(self.n_layer):
            y = getattr(self, f"layer_{i}").step(y, src_kv[i], self_caches[i],
                                                 index, memory_mask)
        return self.linear_out(self.after_norm(y))[:, 0]
