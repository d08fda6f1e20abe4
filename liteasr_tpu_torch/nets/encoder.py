"""Conformer / Transformer encoder (liteasr_tpu/nets/encoder.py).

Conv2D subsample (T -> T') -> (relative) positional encoding -> N layers ->
final LayerNorm. The rel-pos table has the PADDED length T' of the batch,
as in the reference: the legacy rel_shift indexes it from its end.

Streaming (WeNet-style chunked attention): ``static_chunk_size`` > 0 gives
every forward the chunk width c, where key j is hidden from frame t iff
j // c > t // c (``triangle_mask(stage=c)``); ``dynamic_chunk`` draws a
width for every train-mode forward from ``chunk_generator``: full context
with probability 1/2, else U[1, 25] (liteasr_tpu/nets/encoder.py:144-167).
The width reaches the attention kernels as an integer.
:meth:`TransformerEncoder.forward_chunk` is the chunk-by-chunk streaming
step over per-layer K/V caches (``_chunk_forward``, :61-110).

``remat=True`` recomputes each layer's forward in the backward pass of a
train-mode call (``torch.utils.checkpoint``, liteasr_tpu/nets/encoder.py:
53-55, 170-190): the same result and gradients with less activation memory.

Sequence parallelism (``seq_parallel``, set by ``parallel.sharding.
shard_model``; liteasr_tpu/parallel/mesh.py:71-80 shards the features' time
over sp): every sp rank subsamples the whole batch, which is cheap, keeps
its block of the T' frames (:func:`parallel.sharding.seq_shard`) and runs
the layer stack on it; the positional table, the padding mask and the
chunk width are the whole batch's, and :meth:`forward` returns the rank's
block.
"""

import contextlib
import logging
import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from liteasr_tpu_torch.nets.common import (
    LayerNorm, dropout, positional_encoding, relative_positional_encoding, sinusoidal_pe)
from liteasr_tpu_torch.nets.attention import RelativeMultiHeadAttention, rel_chunk_align
from liteasr_tpu_torch.nets.layers import BatchNorm, ConformerLayer, EncoderLayer
from liteasr_tpu_torch.nets.subsampling import Conv2DSubsampling
from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.parallel import sharding

logger = logging.getLogger(__name__)

# the dynamic draw: U[1, MAX_DYNAMIC_CHUNK] subsampled frames when chunked
MAX_DYNAMIC_CHUNK = 25


def subsample_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) padding mask -> (B, T') after the two stride-2 convs
    (reference transformer_encoder.py:118)."""
    return mask[:, :-2:2][:, :-2:2]


@contextlib.contextmanager
def _recompute(layer: nn.Module, streams):
    """The recompute of a rematerialized layer: its BatchNorms leave the
    running statistics alone (the first forward moved them; flax's remat
    drops the recompute's batch_stats update likewise), and its dropouts
    draw the coordinate-keyed streams from the ``streams`` states the
    forward started from, which are left where the forward left them."""
    norms = [m for m in layer.modules() if isinstance(m, BatchNorm)]
    after = parallel.stream_states()
    parallel.set_stream_states(streams)
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True
        parallel.set_stream_states(after)


def remat_layer(layer: nn.Module, x, pos_emb, mask, chunk: int = 0, seq=None):
    """A train-mode layer call whose activations are recomputed in the
    backward pass. The global CPU/CUDA generators of the dropouts are
    replayed by ``checkpoint``, the coordinate-keyed streams of
    ``parallel`` (the dropouts of a tp-sharded region) by :func:`_recompute`;
    the rel-pos attention's kernel seed comes from the layer's own
    generator, which nothing replays, so it is drawn here, once, and handed
    to both the forward and the recompute, as is the chunk width (drawn
    once per encoder forward)."""
    seed = (layer.self_attn.draw_seed()
            if isinstance(layer.self_attn, RelativeMultiHeadAttention) else None)
    streams = parallel.stream_states(x.device)
    return checkpoint(layer, x, pos_emb, mask, True, seed, chunk, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute(layer, streams)),
                      seq=seq)


class TransformerEncoder(nn.Module):
    def __init__(self, input_dim: int, use_rel: bool, h_dim: int, ff_dim: int,
                 n_head: int, n_layer: int, activation: str = "swish",
                 arch: str = "conformer", conv_kernel: int = 15,
                 normalize_before: bool = True, dropout_rate: float = 0.0,
                 pos_dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0,
                 ff_dropout_rate: float = 0.0, remat: bool = False,
                 static_chunk_size: int = 0, dynamic_chunk: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if arch not in ("conformer", "transformer"):
            raise ValueError(f"unknown encoder arch {arch!r}")
        if static_chunk_size < 0:
            raise ValueError(f"static_chunk_size {static_chunk_size} < 0")
        kw = dict(dtype=dtype, device=device)
        rates = (dropout_rate, attn_dropout_rate, ff_dropout_rate)
        self.remat = remat
        self.use_rel = use_rel
        self.arch = arch
        self.pre = normalize_before
        self.n_layer = n_layer
        self.n_head = n_head
        self.h_dim = h_dim
        self.compute_dtype = dtype
        self.static_chunk_size = static_chunk_size
        self.dynamic_chunk = dynamic_chunk
        # draws the dynamic chunk widths (the model shares its own)
        self.chunk_generator = torch.Generator()
        self.pos_dropout_rate = pos_dropout_rate
        self.seq_parallel = False
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

    def draw_chunk(self) -> int:
        """One dynamic chunk width from ``chunk_generator``: 0 (full
        context) with probability 1/2, else U[1, MAX_DYNAMIC_CHUNK], from one
        integer draw w in [0, 2 MAX_DYNAMIC_CHUNK): full context from
        MAX_DYNAMIC_CHUNK on, else the width w + 1."""
        w = int(torch.randint(0, 2 * MAX_DYNAMIC_CHUNK, (), generator=self.chunk_generator))
        chunk = 0 if w >= MAX_DYNAMIC_CHUNK else w + 1
        logger.debug("dynamic chunk width: %s", chunk or "full context")
        return chunk

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                train: bool = False, chunk: Optional[int] = None):
        """:param x: (B, T, F); ``mask``: (B, T) True = padding.
        :param chunk: the chunk width of every layer's self-attention (0 =
            full context); None takes the configured policy: a dynamic draw
            in train mode under ``dynamic_chunk``, else ``static_chunk_size``
        Returns (B, T', h_dim), under sequence parallelism the rank's block
        of the T' frames."""
        if chunk is None:
            chunk = (self.draw_chunk() if self.dynamic_chunk and train
                     else self.static_chunk_size)
        x = self.embed(x)
        seq = None
        if self.seq_parallel:
            x, pos_emb, seq = self._seq_block(x, train)
        elif self.use_rel:
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
                x = remat_layer(layer, x, pos_emb, attn_mask, chunk, seq)
            else:
                x = layer(x, pos_emb, attn_mask, train, None, chunk, seq=seq)
        return self.after_norm(x)

    def _seq_block(self, x, train: bool):
        """The positional encoding of the rank's block of the subsampled
        frames ``x`` (B, T', D): (x's block scaled [+ PE], the whole rel-pos
        table or None, the block). The block's dropout is the rank's own;
        the table's, which every sp and tp peer applies to its copy, comes
        from the dp rank's stream, so that the peers drop it alike."""
        t, d = x.shape[1], x.shape[2]
        seq = sharding.seq_shard(t)
        pe = sinusoidal_pe(t, d, x.dtype, x.device)
        x = x[:, seq.lo:seq.hi] * math.sqrt(d)
        rate = self.pos_dropout_rate
        if self.use_rel:
            return dropout(x, rate, train), dropout(pe, rate, train, stream="dp"), seq
        return dropout(x + pe[:, seq.lo:seq.hi], rate, train), None, seq

    def forward_chunk(self, x, caches: List[Tuple[torch.Tensor, torch.Tensor]],
                      index: int, kv_lens: torch.Tensor, pe_len: int):
        """One streaming step over the layer stack (``_chunk_forward``,
        liteasr_tpu/nets/encoder.py:61-110), eval mode.

        :param x: (B, C + 4, F), one raw conv window whose subsampled frames
            are all new stream frames from position ``index`` on
        :param caches: per layer (k, v), each (B, L, H, Dk), written in place
        :param kv_lens: (B,) valid cached keys after this chunk
        :param pe_len: the positional table's length (the offline padded T'
            for parity: the legacy rel_shift indexes the table from its end)
        Returns the chunk's hidden states (B, c, h_dim)."""
        if self.arch != "transformer":
            raise ValueError("streaming decode needs chunk-causal layers; the "
                             "conformer's conv module and BatchNorm are not")
        if not self.pre:
            raise ValueError("streaming decode assumes pre-LN layers "
                             "(normalize_before=True)")
        x = self.embed(x)
        c_sub, d = x.shape[1], x.shape[2]
        x = x * math.sqrt(d)
        pe = sinusoidal_pe(pe_len, d, x.dtype, x.device)
        if self.use_rel:
            pos_emb = pe
        else:
            x, pos_emb = x + pe[:, index:index + c_sub], None
        # per-query chunk policy (frame t sees keys up to the end of its own
        # static chunk; full left context and the chunk without one) OR the
        # per-row valid-key count (padding and the unwritten cache tail)
        Lk = caches[0][0].shape[1]
        t_g = index + torch.arange(c_sub, device=x.device)[:, None]
        j = torch.arange(Lk, device=x.device)[None, :]
        cs = self.static_chunk_size
        allowed_end = (t_g // cs + 1) * cs if cs > 0 else index + c_sub
        mask = (j >= allowed_end)[None, None] | (j >= kv_lens[:, None])[:, None, None, :]
        align = (rel_chunk_align(index, c_sub, Lk, pe_len, x.device) if self.use_rel
                 else None)
        for i in range(self.n_layer):
            x = getattr(self, f"layer_{i}").forward_chunk(x, pos_emb, mask, caches[i],
                                                          index, align)
        return self.after_norm(x)
