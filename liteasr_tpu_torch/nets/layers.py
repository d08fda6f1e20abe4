"""Transformer / Conformer residual sublayers in eval mode
(liteasr_tpu/nets/layers.py).

``normalize_before=True``: ``x + sublayer(LN(x))``; False:
``LN(x + sublayer(x))``. Dropout is a training-mode op and is not ported.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.nets.attention import (
    MultiHeadAttention, RelativeMultiHeadAttention)
from liteasr_tpu_torch.nets.common import (
    Dense, LayerNorm, PositionwiseFeedForward, get_activation)


class BatchNormEval(nn.Module):
    """BatchNorm from the running statistics, in fp32, eps 1e-5
    (liteasr_tpu/nets/layers.py:43-47). Parameters and buffers match the
    flax variables one to one: scale/bias, batch_stats mean/var."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x):
        y = ((x.float() - self.running_mean)
             * torch.rsqrt(self.running_var + self.eps) * self.weight + self.bias)
        return y.to(x.dtype)


class ConformerConvolution(nn.Module):
    """pointwise -> GLU -> depthwise(k, SAME) -> BatchNorm -> act -> pointwise,
    channel-last like the reference."""

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
        self.norm = BatchNormEval(channels, device=device)
        self.act = get_activation(activation)
        self.pointwise_conv2 = Dense(channels, channels, dtype=dtype,
                                     device=device)

    def forward(self, x):
        dt = self.compute_dtype
        x = F.glu(self.pointwise_conv1(x), dim=-1)
        x = F.conv1d(x.transpose(1, 2), self.depthwise_conv.weight.to(dt),
                     self.depthwise_conv.bias.to(dt),
                     padding=self.depthwise_conv.padding,
                     groups=self.depthwise_conv.groups).transpose(1, 2)
        x = self.norm(x)
        return self.pointwise_conv2(self.act(x.to(dt)))


def _residual(x, norm, fn, pre_ln: bool, scale: float = 1.0):
    """One residual sublayer under either LN placement
    (liteasr_tpu/nets/layers.py:110-114)."""
    y = fn(norm(x) if pre_ln else x)
    x = x + scale * y
    return x if pre_ln else norm(x)


class EncoderLayer(nn.Module):
    """Transformer encoder layer (self-attn + FF)."""

    def __init__(self, d: int, n_head: int, ff_dim: int,
                 activation: str = "relu", use_rel: bool = False,
                 normalize_before: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.use_rel = use_rel
        self.pre = normalize_before
        attn_cls = RelativeMultiHeadAttention if use_rel else MultiHeadAttention
        self.self_attn_norm = LayerNorm(d, **kw)
        self.self_attn = attn_cls(d, n_head, **kw)
        self.feed_forward_norm = LayerNorm(d, **kw)
        self.feed_forward = PositionwiseFeedForward(d, ff_dim, activation, **kw)

    def _attn(self, y, pos_emb, mask):
        if self.use_rel:
            return self.self_attn(y, y, y, pos_emb, mask)
        return self.self_attn(y, y, y, mask)

    def forward(self, x, pos_emb=None, mask: Optional[torch.Tensor] = None):
        x = _residual(x, self.self_attn_norm,
                      lambda y: self._attn(y, pos_emb, mask), self.pre)
        return _residual(x, self.feed_forward_norm, self.feed_forward,
                         self.pre)


class ConformerLayer(EncoderLayer):
    """Conformer block: macaron FF x0.5 -> MHA -> conv -> FF x0.5 ->
    final LN."""

    def __init__(self, d: int, n_head: int, ff_dim: int,
                 conv_kernel: int = 15, activation: str = "swish",
                 use_rel: bool = True, normalize_before: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(d, n_head, ff_dim, activation, use_rel,
                         normalize_before, dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.feed_forward_macaron_norm = LayerNorm(d, **kw)
        self.feed_forward_macaron = PositionwiseFeedForward(
            d, ff_dim, activation, **kw)
        self.conv_norm = LayerNorm(d, **kw)
        self.conv = ConformerConvolution(d, conv_kernel, activation, **kw)
        self.final_norm = LayerNorm(d, **kw)

    def forward(self, x, pos_emb=None, mask: Optional[torch.Tensor] = None):
        pre = self.pre
        x = _residual(x, self.feed_forward_macaron_norm,
                      self.feed_forward_macaron, pre, scale=0.5)
        x = _residual(x, self.self_attn_norm,
                      lambda y: self._attn(y, pos_emb, mask), pre)
        x = _residual(x, self.conv_norm, self.conv, pre)
        x = _residual(x, self.feed_forward_norm, self.feed_forward, pre,
                      scale=0.5)
        return self.final_norm(x)


class DecoderLayer(nn.Module):
    """Self-attn + src-attn + FF, full mode."""

    def __init__(self, d: int, n_head: int, ff_dim: int,
                 normalize_before: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.pre = normalize_before
        self.self_attn_norm = LayerNorm(d, **kw)
        self.self_attn = MultiHeadAttention(d, n_head, **kw)
        self.src_attn_norm = LayerNorm(d, **kw)
        self.src_attn = MultiHeadAttention(d, n_head, **kw)
        self.feed_forward_norm = LayerNorm(d, **kw)
        self.feed_forward = PositionwiseFeedForward(d, ff_dim, **kw)

    def forward(self, y, memory, mask=None, memory_mask=None):
        y = _residual(y, self.self_attn_norm,
                      lambda z: self.self_attn(z, z, z, mask), self.pre)
        y = _residual(y, self.src_attn_norm,
                      lambda z: self.src_attn(z, memory, memory, memory_mask),
                      self.pre)
        return _residual(y, self.feed_forward_norm, self.feed_forward,
                         self.pre)
