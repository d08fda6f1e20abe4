"""Transformer / Conformer residual sublayers (liteasr_tpu/nets/layers.py).

``normalize_before=True``: ``x + drop(sublayer(LN(x)))``; False:
``LN(x + drop(sublayer(x)))``. ``train`` turns on the dropouts and the
batch statistics of the conformer's BatchNorm. ``chunk`` is the self-
attention's chunk width (0 = none). ``seq`` (a ``parallel.sharding.
SeqShard``) runs a layer on the rank's block of frames under sequence
parallelism: the self-attention gathers its keys, the conv module reads
its halo. ``EncoderLayer.forward_chunk`` is the streaming step (mode
``chunk``), pre-LN only, as in the reference.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.nets.attention import (
    MultiHeadAttention, RelativeMultiHeadAttention)
from liteasr_tpu_torch.nets.common import (
    Dense, LayerNorm, PositionwiseFeedForward, dropout, get_activation)
from liteasr_tpu_torch.ops.batch_norm import train_batch_norm
from liteasr_tpu_torch.parallel import sharding


class BatchNorm(nn.Module):
    """``FusedBatchNorm`` (liteasr_tpu/nets/layers.py:22-53), eps 1e-5.

    Eval: the running statistics, in fp32. Train: the batch statistics over
    all B x T frames (biased variance, closed-form backward,
    ops/batch_norm.py) and the running update ``0.99 old + 0.01 batch``
    with that same biased variance (torch's BatchNorm1d would fold in the
    unbiased one). Parameters and buffers match the flax variables one to
    one: scale/bias, batch_stats mean/var."""

    momentum = 0.99

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        # False while a rematerialized layer recomputes its forward: the
        # first forward already moved the running statistics
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x, train: bool = False, frames: Optional[int] = None):
        """``frames``: the full time axis of a rank's block under sequence
        parallelism (the statistics' frame count)."""
        if train:
            y, mean, var = train_batch_norm(x, self.weight, self.bias, self.eps, frames)
            if not self.update_stats:
                return y
            m = self.momentum
            with torch.no_grad():  # in place, like flax's mutable batch_stats
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
            return y
        y = ((x.float() - self.running_mean)
             * torch.rsqrt(self.running_var + self.eps) * self.weight + self.bias)
        return y.to(x.dtype)


class ConformerConvolution(nn.Module):
    """pointwise -> GLU -> depthwise(k, SAME) -> BatchNorm -> act -> pointwise,
    channel-last like the reference. Under tensor parallelism (``tp``, see
    ``parallel.sharding``) the rank holds its GLU pairs' channels from
    ``pointwise_conv1`` to the row-parallel ``pointwise_conv2``."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 activation: str = "swish", *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if (kernel_size - 1) % 2:
            raise ValueError(f"kernel_size {kernel_size} must be odd")
        self.compute_dtype = dtype
        self.pointwise_conv1 = Dense(channels, 2 * channels, dtype=dtype,
                                     device=device)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, padding=(kernel_size - 1) // 2,
            groups=channels, device=device, dtype=torch.float32)
        self.norm = BatchNorm(channels, device=device)
        self.act = get_activation(activation)
        self.pointwise_conv2 = Dense(channels, channels, dtype=dtype,
                                     device=device)
        self.tp = False

    def forward(self, x, train: bool = False,
                seq: Optional[sharding.SeqShard] = None):
        dt = self.compute_dtype
        if self.tp:
            x = sharding.copy_to_tp(x)
        x = F.glu(self.pointwise_conv1(x), dim=-1)
        padding = self.depthwise_conv.padding
        if seq is not None:  # the neighbours' frames stand for the padding
            x, padding = sharding.sp_halo(x, padding[0], seq), 0
        x = F.conv1d(x.transpose(1, 2), self.depthwise_conv.weight.to(dt),
                     self.depthwise_conv.bias.to(dt), padding=padding,
                     groups=self.depthwise_conv.groups).transpose(1, 2)
        x = self.norm(x, train, seq.total if seq is not None else None)
        return self.pointwise_conv2(self.act(x.to(dt)))


def _residual(x, norm, fn, pre_ln: bool, rate: float, train: bool,
              scale: float = 1.0):
    """One residual sublayer under either LN placement, with the residual
    dropout (liteasr_tpu/nets/layers.py:110-114)."""
    y = fn(norm(x) if pre_ln else x)
    x = x + scale * dropout(y, rate, train)
    return x if pre_ln else norm(x)


class EncoderLayer(nn.Module):
    """Transformer encoder layer (self-attn + FF)."""

    def __init__(self, d: int, n_head: int, ff_dim: int,
                 activation: str = "relu", use_rel: bool = False,
                 normalize_before: bool = True, dropout_rate: float = 0.0,
                 attn_dropout_rate: float = 0.0, ff_dropout_rate: float = 0.0,
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.use_rel = use_rel
        self.pre = normalize_before
        self.dropout_rate = dropout_rate
        attn_cls = RelativeMultiHeadAttention if use_rel else MultiHeadAttention
        self.self_attn_norm = LayerNorm(d, **kw)
        self.self_attn = attn_cls(d, n_head, attn_dropout_rate, **kw)
        self.feed_forward_norm = LayerNorm(d, **kw)
        self.feed_forward = PositionwiseFeedForward(d, ff_dim, activation,
                                                    ff_dropout_rate, **kw)

    def _attn(self, y, pos_emb, mask, train, attn_seed, chunk, seq=None):
        if self.use_rel:
            return self.self_attn(y, y, y, pos_emb, mask, train, attn_seed, chunk, seq=seq)
        return self.self_attn(y, y, y, mask, train, chunk, seq=seq)

    def _res(self, x, norm, fn, train, scale=1.0):
        return _residual(x, norm, fn, self.pre, self.dropout_rate, train,
                         scale)

    def forward(self, x, pos_emb=None, mask: Optional[torch.Tensor] = None,
                train: bool = False, attn_seed: Optional[int] = None,
                chunk: int = 0, seq: Optional[sharding.SeqShard] = None):
        """``attn_seed``: the rel-pos attention's dropout seed, drawn by the
        caller (see ``RelativeMultiHeadAttention.forward``)."""
        x = self._res(x, self.self_attn_norm,
                      lambda y: self._attn(y, pos_emb, mask, train, attn_seed, chunk, seq),
                      train)
        return self._res(x, self.feed_forward_norm,
                         lambda y: self.feed_forward(y, train), train)

    def forward_chunk(self, x, pos_emb, mask, cache, index: int, align=None):
        """One streaming step (liteasr_tpu/nets/layers.py:136-156): the
        self-attention's ``chunk_step`` over ``cache`` (written in place at
        ``index``), then the feed-forward; eval mode. ``align``: the rel-pos
        alignment (:func:`rel_chunk_align`), None without rel-pos."""
        if not self.pre:
            raise ValueError("streaming decode assumes pre-LN layers "
                             "(normalize_before=True)")
        z = self.self_attn_norm(x)
        if self.use_rel:
            x = x + self.self_attn.chunk_step(z, pos_emb, cache, index, mask, align)
        else:
            x = x + self.self_attn.chunk_step(z, cache, index, mask)
        return x + self.feed_forward(self.feed_forward_norm(x), False)


class ConformerLayer(EncoderLayer):
    """Conformer block: macaron FF x0.5 -> MHA -> conv -> FF x0.5 ->
    final LN."""

    def __init__(self, d: int, n_head: int, ff_dim: int,
                 conv_kernel: int = 15, activation: str = "swish",
                 use_rel: bool = True, normalize_before: bool = True,
                 dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0,
                 ff_dropout_rate: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(d, n_head, ff_dim, activation, use_rel,
                         normalize_before, dropout_rate, attn_dropout_rate,
                         ff_dropout_rate, dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.feed_forward_macaron_norm = LayerNorm(d, **kw)
        self.feed_forward_macaron = PositionwiseFeedForward(
            d, ff_dim, activation, ff_dropout_rate, **kw)
        self.conv_norm = LayerNorm(d, **kw)
        self.conv = ConformerConvolution(d, conv_kernel, activation, **kw)
        self.final_norm = LayerNorm(d, **kw)

    def forward(self, x, pos_emb=None, mask: Optional[torch.Tensor] = None,
                train: bool = False, attn_seed: Optional[int] = None,
                chunk: int = 0, seq: Optional[sharding.SeqShard] = None):
        x = self._res(x, self.feed_forward_macaron_norm,
                      lambda y: self.feed_forward_macaron(y, train), train,
                      scale=0.5)
        x = self._res(x, self.self_attn_norm,
                      lambda y: self._attn(y, pos_emb, mask, train, attn_seed, chunk, seq),
                      train)
        x = self._res(x, self.conv_norm, lambda y: self.conv(y, train, seq), train)
        x = self._res(x, self.feed_forward_norm,
                      lambda y: self.feed_forward(y, train), train, scale=0.5)
        return self.final_norm(x)


class DecoderLayer(nn.Module):
    """Self-attn + src-attn + FF: full mode (``forward``) and the cached
    decode step (``step``; liteasr_tpu/nets/layers.py:246-276)."""

    def __init__(self, d: int, n_head: int, ff_dim: int,
                 normalize_before: bool = True, dropout_rate: float = 0.0,
                 self_attn_dropout_rate: float = 0.0,
                 src_attn_dropout_rate: float = 0.0,
                 ff_dropout_rate: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.pre = normalize_before
        self.dropout_rate = dropout_rate
        self.self_attn_norm = LayerNorm(d, **kw)
        self.self_attn = MultiHeadAttention(d, n_head, self_attn_dropout_rate,
                                            **kw)
        self.src_attn_norm = LayerNorm(d, **kw)
        self.src_attn = MultiHeadAttention(d, n_head, src_attn_dropout_rate,
                                           **kw)
        self.feed_forward_norm = LayerNorm(d, **kw)
        self.feed_forward = PositionwiseFeedForward(
            d, ff_dim, dropout_rate=ff_dropout_rate, **kw)

    def forward(self, y, memory, mask=None, memory_mask=None,
                train: bool = False):
        rate, pre = self.dropout_rate, self.pre
        y = _residual(y, self.self_attn_norm,
                      lambda z: self.self_attn(z, z, z, mask, train), pre,
                      rate, train)
        y = _residual(y, self.src_attn_norm,
                      lambda z: self.src_attn(z, memory, memory, memory_mask,
                                              train), pre, rate, train)
        return _residual(y, self.feed_forward_norm,
                         lambda z: self.feed_forward(z, train), pre, rate,
                         train)

    def step(self, y, src_kv, self_cache, index: int, memory_mask=None):
        """One (B, 1, D) token at position ``index`` (``mode="step"``, pre-LN
        only, as in the reference): ``self_cache`` (k, v) is written in
        place at ``index``; ``src_kv`` is :meth:`MultiHeadAttention.prime_kv`
        of the memory; ``memory_mask`` (B, 1, 1, T') or None."""
        if not self.pre:
            raise ValueError("cached decoding assumes pre-LN layers "
                             "(normalize_before=True)")
        y = y + self.self_attn.step_self(self.self_attn_norm(y), self_cache, index)
        y = y + self.src_attn.step_src(self.src_attn_norm(y), src_kv, memory_mask)
        return y + self.feed_forward(self.feed_forward_norm(y), False)
