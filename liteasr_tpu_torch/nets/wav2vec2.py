"""wav2vec 2.0 building blocks: the conv feature extractor, the Gumbel
vector quantizer and the conv-positional transformer encoder
(liteasr_tpu/nets/wav2vec2.py).

Like the reference, activations are channel-last (B, T, C): each strided
conv runs as a channel-first ``Conv1d`` on a transposed view, and its
LayerNorm normalizes over the channels. The GELU is flax's tanh
approximation (``nn.gelu``'s default), not ``F.gelu``'s erf form.

The quantizer takes its Gumbel noise as an argument in training: the
model draws it (``Wav2Vec2.draw_gumbel_noise``), so that a test can hand
in the reference's. Its straight-through code weights are the one-hot
exactly, so two frames with the same codes get bit-identical targets in
any precision (the -inf logits of ``Wav2Vec2.compute_logits``).
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.nets.common import Dense, LayerNorm, dropout, get_activation
from liteasr_tpu_torch.nets.layers import EncoderLayer
from liteasr_tpu_torch.parallel import sharding

gelu = get_activation("gelu")


def wide_float(dtype: torch.dtype) -> torch.dtype:
    """fp32, or fp64 where the model computes in fp64: the type of the
    parts the reference computes in fp32 whatever its compute dtype."""
    return torch.promote_types(dtype, torch.float32)


class ConvFeatureExtractor(nn.Module):
    """Strided VALID 1-D convs, each followed by fp32 LayerNorm over the
    channels and GELU (liteasr_tpu/nets/wav2vec2.py:23-46, whose dropout
    there the model leaves at 0).

    ``conv_layers``: ((dim, kernel, stride), ...); the default stack
    downsamples 16 kHz waves by 320."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]],
                 conv_bias: bool = False, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.conv_layers = tuple(tuple(c) for c in conv_layers)
        self.compute_dtype = dtype
        in_dim = 1
        for i, (dim, kernel, stride) in enumerate(self.conv_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(
                in_dim, dim, kernel, stride, bias=conv_bias, device=device,
                dtype=torch.float32))
            self.add_module(f"ln_{i}", LayerNorm(dim, dtype=dtype, device=device))
            in_dim = dim

    def forward(self, x):
        """x: (B, T) waveform -> (B, frames, C)."""
        dt = self.compute_dtype
        x = x.to(dt)[:, :, None]
        for i in range(len(self.conv_layers)):
            conv = getattr(self, f"conv_{i}")
            bias = None if conv.bias is None else conv.bias.to(dt)
            x = F.conv1d(x.transpose(1, 2), conv.weight.to(dt), bias,
                         stride=conv.stride).transpose(1, 2)
            x = gelu(getattr(self, f"ln_{i}")(x))
        return x


def conv_output_length(length: int,
                       conv_layers: Sequence[Tuple[int, int, int]]) -> int:
    for _, kernel, stride in conv_layers:
        length = (length - kernel) // stride + 1
    return length


def sample_window(lo: int, hi: int,
                  conv_layers: Sequence[Tuple[int, int, int]]) -> Tuple[int, int]:
    """The samples [a, b) that the extractor's frames [lo, hi) read: frame
    f reads [S f, S f + R) for the stack's total stride S and receptive
    field R (320 and 400 for the default stack), so the VALID convs over
    the window give exactly those frames."""
    stride, field = 1, 1
    for _, kernel, s in conv_layers:
        field += (kernel - 1) * stride
        stride *= s
    return stride * lo, stride * (hi - 1) + field


class GumbelVectorQuantizer(nn.Module):
    """Grouped codebook, hard one-hot at eval and the straight-through
    Gumbel-softmax in training (liteasr_tpu/nets/wav2vec2.py:56-119)."""

    def __init__(self, in_dim: int, num_vars: int, groups: int, vq_dim: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if vq_dim % groups:
            raise ValueError(f"vq_dim {vq_dim} is not a multiple of {groups} groups")
        self.num_vars = num_vars
        self.groups = groups
        self.vq_dim = vq_dim
        self.compute_dtype = dtype
        self.vars = nn.Parameter(torch.empty(1, groups * num_vars, vq_dim // groups,
                                             device=device))
        self.weight_proj = Dense(in_dim, groups * num_vars, dtype=dtype, device=device)

    def forward(self, x, temp=2.0, train: bool = False,
                frame_weight: Optional[torch.Tensor] = None,
                gumbels: Optional[torch.Tensor] = None):
        """x (B, T, D) -> (quantized (B, T, vq_dim) in the compute dtype,
        avg_probs (G, V)). ``frame_weight`` (B, T) weights the code-usage
        statistics, taken over the global batch under a process group;
        ``gumbels`` (B T G, V) is the training noise."""
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        wide = wide_float(self.compute_dtype)
        logits = self.weight_proj(x).reshape(B * T * G, V).to(wide)

        probs = torch.softmax(logits.reshape(B * T, G, V), dim=-1)
        if frame_weight is None:
            num, den = probs.sum(dim=0), probs.new_full((), float(B * T))
        else:
            w = frame_weight.to(wide).reshape(B * T, 1, 1)
            num, den = (probs * w).sum(dim=0), w.sum()
        if parallel.is_initialized():  # the global batch's usage: every frame's
            tot = parallel.global_sum_grad(
                torch.cat([num.reshape(-1), den.reshape(1)]), "code_usage", over="dpsp")
            num, den = tot[:-1].reshape(G, V), tot[-1]
        avg_probs = num / torch.clamp(den.detach(), min=1.0)

        if train:
            if gumbels is None:
                raise ValueError("the training quantizer needs its Gumbel noise")
            y_soft = torch.softmax((logits + gumbels.to(wide)) / temp, dim=-1)
            hard = F.one_hot(torch.argmax(y_soft, dim=-1), V).to(wide)
            # straight-through: the value is the one-hot exactly, where the
            # reference's (hard + y_soft) - y_soft is 1 - 2^-24 at some codes
            # by the last bit of y_soft; the gradient is the same
            x_sel = hard + (y_soft - y_soft.detach())
        else:
            x_sel = F.one_hot(torch.argmax(logits, dim=-1), V).to(wide)

        # the reference's sum over codes of x_sel x vars, as one product
        out = torch.einsum("ngv,gvd->ngd", x_sel.reshape(B * T, G, V),
                           self.vars.to(wide).reshape(G, V, -1))
        return out.reshape(B, T, self.vq_dim).to(self.compute_dtype), avg_probs


class Wav2Vec2TransformerEncoder(nn.Module):
    """Conv positional embedding (grouped, even kernel, the extra frame cut
    off), ``residual + gelu(pos)``, ``embed_norm``, dropout, then pre-LN
    transformer layers with relu and no final norm
    (liteasr_tpu/nets/wav2vec2.py:122-161). The layers' self-attention is
    the absolute one: K1 at eval, plain PyTorch in training. ``seq`` (a
    ``parallel.sharding.SeqShard``): the rank's block of frames under
    sequence parallelism."""

    def __init__(self, h_dim: int, ff_dim: int, n_head: int, n_layer: int,
                 dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0,
                 ff_dropout_rate: float = 0.0, conv_pos: int = 128,
                 conv_pos_groups: int = 16, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.pos_conv = nn.Conv1d(h_dim, h_dim, conv_pos, padding=conv_pos // 2,
                                  groups=conv_pos_groups, device=device,
                                  dtype=torch.float32)
        self.embed_norm = LayerNorm(h_dim, dtype=dtype, device=device)
        self.n_layer = n_layer
        for i in range(n_layer):
            self.add_module(f"layer_{i}", EncoderLayer(
                h_dim, n_head, ff_dim, activation="relu", use_rel=False,
                dropout_rate=dropout_rate, attn_dropout_rate=attn_dropout_rate,
                ff_dropout_rate=ff_dropout_rate, dtype=dtype, device=device))

    def embed(self, x, seq: Optional[sharding.SeqShard] = None):
        """``embed_norm(x + gelu(pos_conv(x)))``, the layers' input before
        dropout. Under sequence parallelism output frame t reads input
        frames t - k/2 .. t + k/2 - 1 of the whole row: the neighbours'
        frames stand for the padding, zeros only at the row's ends."""
        dt = self.compute_dtype
        conv = self.pos_conv
        h, padding = x.to(dt), conv.padding
        if seq is not None:
            h, padding = sharding.sp_halo(h, padding[0], seq), 0
        pos = F.conv1d(h.transpose(1, 2), conv.weight.to(dt), conv.bias.to(dt),
                       padding=padding, groups=conv.groups).transpose(1, 2)
        return self.embed_norm(x + gelu(pos[:, : x.shape[1]]))  # even kernel: drop the extra frame

    def forward(self, x, train: bool = False, seq: Optional[sharding.SeqShard] = None):
        x = dropout(self.embed(x, seq), self.dropout_rate, train)
        for i in range(self.n_layer):
            x = getattr(self, f"layer_{i}")(x, train=train, seq=seq)
        return x
