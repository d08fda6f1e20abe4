"""LayerNorm(eps=1e-12), swish, FFN, positional encodings, dropout
(liteasr_tpu/nets/common.py).

Every layer keeps fp32 parameters and computes in its ``dtype``, casting
inputs and parameters explicitly where flax's ``dtype=`` promotes them.
Forwards take ``train`` explicitly, as the reference's do: dropout runs only
when it is true, and draws from the device's default torch generator.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.ops.layer_norm import layer_norm


class Dense(nn.Linear):
    """``flax.linen.Dense(dtype=dtype)``: fp32 parameters, computed in
    ``dtype``. ``weight`` is (out, in), the transpose of flax's kernel.
    ``tp_reduce`` (set by ``parallel.sharding.shard_model``): a row-parallel
    layer, whose partial products the tp ranks sum before the bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype
        self.tp_reduce = False

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if not self.tp_reduce:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        from liteasr_tpu_torch.parallel.sharding import reduce_from_tp

        y = reduce_from_tp(F.linear(x.to(dt), self.weight.to(dt)))
        return y if bias is None else y + bias


class LayerNorm(nn.Module):
    """fp32 statistics, output cast to ``dtype``
    (liteasr_tpu/nets/common.py:32-44, ops/layer_norm.py:29-37): the
    function ``ops.layer_norm.layer_norm``, its kernels on a CUDA device."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.compute_dtype = dtype

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.compute_dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            stream: Optional[str] = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``: keep with
    probability 1 - rate, scale kept values by 1 / (1 - rate). ``stream``
    names a coordinate-keyed generator of ``parallel`` to draw from (a
    tp-sharded activation's, "tp"; an activation every tp and sp peer holds
    whole, "dp"); None draws from the device's default generator."""
    if not train or rate == 0.0:
        return x
    if stream is None:
        return F.dropout(x, rate, training=True)
    from liteasr_tpu_torch import parallel

    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - rate, generator=parallel.stream(stream, x.device))
    return x * (keep / (1.0 - rate)).to(x.dtype)


def swish(x):
    return x * torch.sigmoid(x)


_ACTIVATIONS = {
    "relu": F.relu,
    "swish": swish,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu
}


def get_activation(name: str):
    return _ACTIVATIONS[name]


class PositionwiseFeedForward(nn.Module):
    """fc1 -> act -> dropout -> fc2 (liteasr_tpu/nets/common.py:62-76)."""

    def __init__(self, d: int, h_units: int, activation: str = "relu",
                 dropout_rate: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(d, h_units, dtype=dtype, device=device)
        self.fc2 = Dense(h_units, d, dtype=dtype, device=device)
        self.act = get_activation(activation)
        self.dropout_rate = dropout_rate
        self.tp = False  # fc1 column- and fc2 row-parallel over the tp group

    def forward(self, x, train: bool = False):
        if not self.tp:
            return self.fc2(dropout(self.act(self.fc1(x)), self.dropout_rate, train))
        from liteasr_tpu_torch.parallel.sharding import copy_to_tp

        x = self.act(self.fc1(copy_to_tp(x)))
        return self.fc2(dropout(x, self.dropout_rate, train, stream="tp"))


def _sinusoid(position: torch.Tensor, dim: int) -> torch.Tensor:
    """(N, dim) sin and cos INTERLEAVED at the fp32 ``position`` (N,)."""
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=position.device)
        * -(math.log(10000.0) / dim))
    rad = position[:, None] * div_term
    return torch.stack([torch.sin(rad), torch.cos(rad)], dim=-1).reshape(-1, dim)


def sinusoidal_pe(length: int, dim: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """(1, length, dim) table (liteasr_tpu/nets/common.py:79-89)."""
    position = torch.arange(length, dtype=torch.float32, device=device)
    return _sinusoid(position, dim)[None].to(dtype)


def sinusoidal_pe_at(pos: int, dim: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """(1, 1, dim) embedding at one position, the single-step counterpart
    of :func:`sinusoidal_pe` for cached decoding
    (liteasr_tpu/nets/common.py:92-99)."""
    position = torch.full((1,), float(pos), dtype=torch.float32, device=device)
    return _sinusoid(position, dim)[None].to(dtype)


def positional_encoding(x: torch.Tensor, dropout_rate: float = 0.0,
                        train: bool = False) -> torch.Tensor:
    """x * sqrt(d) + PE, then dropout (PositionalEncoding,
    liteasr_tpu/nets/common.py:102-112)."""
    d = x.shape[-1]
    x = x * math.sqrt(d) + sinusoidal_pe(x.shape[1], d, x.dtype, x.device)
    return dropout(x, dropout_rate, train)


def relative_positional_encoding(
        x: torch.Tensor, dropout_rate: float = 0.0,
        train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x * sqrt(d), pos_emb), both dropped (RelativePositionalEncoding,
    liteasr_tpu/nets/common.py:115-127)."""
    d = x.shape[-1]
    pos_emb = sinusoidal_pe(x.shape[1], d, x.dtype, x.device)
    return (dropout(x * math.sqrt(d), dropout_rate, train),
            dropout(pos_emb, dropout_rate, train))


def xavier_uniform_(t: torch.Tensor, generator: Optional[torch.Generator]):
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]):
    """flax's default kernel init: truncated normal (2 sigma) of variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)
