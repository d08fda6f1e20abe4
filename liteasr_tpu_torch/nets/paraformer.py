"""Paraformer building blocks: the CIF predictor, the non-causal parallel
decoder, the glancing sampler (liteasr_tpu/nets/paraformer.py).

Continuous integrate-and-fire (CIF) in two forms with the same values and
gradients: :func:`cif_scan`, the loop over frames (the oracle and the path
for long sequences), and :func:`cif_dense`, the closed form of cumsum +
cummin + one batched matmul over a (B, U, T) weight matrix. The
:class:`Predictor` picks one by the size of that matrix
(``U * T <= DENSE_CIF_MAX_CELLS``) unless ``dense_cif`` forces a path.
The glancing sampler takes its (B, U) uniform noise from the caller, who
draws it from an explicit generator.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.nets.common import Dense, LayerNorm
from liteasr_tpu_torch.nets.encoder import subsample_mask
from liteasr_tpu_torch.nets.layers import DecoderLayer
from liteasr_tpu_torch.ops.masks import padding_mask

# above this many weight-matrix cells (U * T) the closed form would
# materialize too large a (B, U, T) tensor; the scan takes over
# (liteasr_tpu/nets/paraformer.py:27-29)
DENSE_CIF_MAX_CELLS = 512 * 1024


def cif_scan(alpha, xs32, beta, U: int):
    """Integrate-and-fire as a loop over the T frames
    (liteasr_tpu/nets/paraformer.py:32-71).

    :param alpha: (B, T) fp32 weights; ``xs32``: (B, T, D) fp32 states;
        ``beta``: (B,) firing threshold
    :return: (B, U, D): the first U fired vectors in firing order, zeros
        after the last

    The not-fired accumulation is the reference's ``prev_state + (beta -
    prev_alpha) * cur_state``. Each frame's fired vector lands in row
    ``count`` of the output, written once at the end by one scatter (a
    frame that does not write goes to a dropped row U)."""
    B, T, D = xs32.shape
    if T == 0:
        return xs32.new_zeros(B, U, D)
    prev_alpha = xs32.new_zeros(B)
    prev_state = xs32.new_zeros(B, D)
    count = torch.zeros(B, dtype=torch.int64, device=xs32.device)
    fired_states, rows = [], []
    for t in range(T):
        cur_state = xs32[:, t]
        new_alpha = prev_alpha + alpha[:, t]
        is_fired = new_alpha >= beta
        left = (beta - prev_alpha)[:, None]
        right = (new_alpha - beta)[:, None]
        fired_state = prev_state + left * cur_state
        write = is_fired & (count < U)
        fired_states.append(fired_state)
        rows.append(torch.where(write, count, U))
        prev_alpha = torch.where(is_fired, right[:, 0], new_alpha)
        prev_state = torch.where(is_fired[:, None], right * cur_state, fired_state)
        count = count + write.long()
    idx = torch.stack(rows, dim=1)[:, :, None].expand(B, T, D)
    buf = xs32.new_zeros(B, U + 1, D).scatter_add(1, idx, torch.stack(fired_states, 1))
    return buf[:, :U]


def fire_counts(csum, beta):
    """(B, T) int64 fires so far at each frame, from the cumulative alpha
    ``csum`` (B, T) and the threshold ``beta`` (B,): ``k[t] =
    min(floor(csum[t] / beta), k[t-1] + 1)`` (at most one fire a frame, each
    taking exactly beta), unrolled as ``t + min(1, min_{s<=t}(floor(csum[s] /
    beta) - s))``, a cummin. ``beta <= 0`` (the scan fires every frame)
    divides by ``max(beta, 1e-8)``, which the clamp turns into a fire on
    every frame."""
    ar = torch.arange(csum.shape[1], device=csum.device)
    f = torch.floor(csum / torch.clamp(beta, min=1e-8)[:, None]).long()
    return ar[None, :] + torch.clamp(torch.cummin(f - ar[None, :], dim=1).values, max=1)


def cif_dense(alpha, xs32, beta, U: int):
    """Closed-form integrate-and-fire (liteasr_tpu/nets/paraformer.py:74-127):
    arguments and result as :func:`cif_scan`.

    The fires so far ``k`` are :func:`fire_counts` of the detached csum
    (the integers carry no gradient). Frame t gives ``(k[t-1] + 1) beta -
    csum[t-1]`` of its state to the token it lands in and, when it fires,
    ``csum[t] - k[t] beta`` to the next; a token exists iff its index is
    below the total fires. Those weights form a (B, U, T) matrix, and the
    integration is one fp32 ``torch.bmm``."""
    csum = torch.cumsum(alpha, dim=1)
    csum_prev = F.pad(csum[:, :-1], (1, 0))
    k = fire_counts(csum.detach(), beta.detach())  # (B, T)
    k_prev = F.pad(k[:, :-1], (1, 0))
    k_total = k[:, -1:]
    fired = k > k_prev
    w_cur = (k_prev + 1).float() * beta[:, None] - csum_prev
    w_next = csum - k.float() * beta[:, None]
    u_ar = torch.arange(U, device=xs32.device)[None, :, None]  # (1, U, 1)
    cur_w = torch.where((k_prev[:, None, :] == u_ar) & (k_prev < k_total)[:, None, :],
                        w_cur[:, None, :], 0.0)
    next_w = torch.where((k[:, None, :] == u_ar) & (fired & (k < k_total))[:, None, :],
                         w_next[:, None, :], 0.0)
    return torch.bmm(cur_w + next_w, xs32)


class Predictor(nn.Module):
    """CIF predictor (liteasr_tpu/nets/paraformer.py:130-190): Conv1d (k=3,
    SAME) -> ReLU -> Dense(1) -> sigmoid in the compute dtype gives the fp32
    alpha, zeroed past ``xlens`` after the conv (the conv reads the padded
    frames, as flax's does); then integrate-and-fire in fp32 with ``beta =
    sum_alpha / max(ulens, 1) - 1e-4``.

    ``dense_cif``: None takes :func:`cif_dense` when ``U * T <=
    DENSE_CIF_MAX_CELLS`` (a bound on the (B, U, T) weight matrix) and
    :func:`cif_scan` otherwise; True / False forces a path."""

    def __init__(self, dim: int, dense_cif: Optional[bool] = None, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.dense_cif = dense_cif
        self.conv = nn.Conv1d(dim, dim, 3, padding=1, device=device, dtype=torch.float32)
        self.lin = Dense(dim, 1, dtype=dtype, device=device)

    def alphas(self, xs, xlens=None, ylens=None):
        """(alpha (B, T') fp32, beta (B,)) of the encoder output ``xs``:
        ``xlens`` (B,) valid frames or None; ``ylens`` (B,) target lengths
        (training), None at inference, where the token count is
        ``round(sum_alpha)``."""
        dt = self.compute_dtype
        a = F.conv1d(xs.to(dt).transpose(1, 2), self.conv.weight.to(dt),
                     self.conv.bias.to(dt), padding=1).transpose(1, 2)
        alpha = torch.sigmoid(self.lin(F.relu(a)))[..., 0].float()
        if xlens is not None:
            alpha = alpha.masked_fill(padding_mask(xlens, xs.shape[1]), 0.0)
        sum_alpha = alpha.sum(dim=1)
        if ylens is not None:
            ulens = torch.clamp(ylens.float(), min=1.0)
        else:
            ulens = torch.clamp(torch.round(sum_alpha), min=1.0)
        return alpha, sum_alpha / ulens - 1e-4  # the reference's precision margin

    def forward(self, xs, xlens=None, ylens=None, u_max: Optional[int] = None):
        """:param xs: (B, T', D) encoder output; ``xlens``, ``ylens``: as
            :meth:`alphas`
        :param u_max: the output width, default T'
        :return: (h_cif (B, u_max, D) in the compute dtype, sum_alpha (B,))"""
        T = xs.shape[1]
        U = u_max or T
        alpha, beta = self.alphas(xs, xlens, ylens)
        sum_alpha = alpha.sum(dim=1)
        dense = U * T <= DENSE_CIF_MAX_CELLS if self.dense_cif is None else self.dense_cif
        buf = (cif_dense if dense else cif_scan)(alpha, xs.float(), beta, U)
        return buf.to(self.compute_dtype), sum_alpha


class ParallelDecoder(nn.Module):
    """Non-causal decoder over the CIF vectors, without positional encoding
    (liteasr_tpu/nets/paraformer.py:193-225): ``n_layer`` DecoderLayers
    with no self-attention mask and the subsampled padding mask on the
    source, then ``after_norm`` and ``linear_out``."""

    def __init__(self, vocab_size: int, h_dim: int, ff_dim: int, n_head: int,
                 n_layer: int, dropout_rate: float = 0.0,
                 self_attn_dropout_rate: float = 0.0,
                 src_attn_dropout_rate: float = 0.0, ff_dropout_rate: float = 0.0,
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_layer = n_layer
        for i in range(n_layer):
            self.add_module(f"layer_{i}", DecoderLayer(
                h_dim, n_head, ff_dim, normalize_before=True, dropout_rate=dropout_rate,
                self_attn_dropout_rate=self_attn_dropout_rate,
                src_attn_dropout_rate=src_attn_dropout_rate,
                ff_dropout_rate=ff_dropout_rate, **kw))
        self.after_norm = LayerNorm(h_dim, **kw)
        self.linear_out = Dense(h_dim, vocab_size, **kw)

    def forward(self, y, memory, memory_mask: Optional[torch.Tensor] = None,
                train: bool = False):
        """:param y: (B, U, D) CIF vectors; ``memory``: (B, T', D)
        :param memory_mask: (B, T) padding mask before subsampling, or None
        :return: (B, U, vocab) logits"""
        mm = None
        if memory_mask is not None:
            mm = subsample_mask(memory_mask)[:, None, None, :]
        for i in range(self.n_layer):
            y = getattr(self, f"layer_{i}")(y, memory, None, mm, train)
        return self.linear_out(self.after_norm(y))


def glancing_sample(noise, hs, embed_ys, ys, ys_hat, ylens, sample_ratio):
    """Mix ground-truth embeddings into the CIF vectors
    (liteasr_tpu/nets/paraformer.py:228-243): per row, the ``ceil(ratio *
    hamming(ys_hat, ys))`` valid positions of lowest ``noise`` take
    ``embed_ys``.

    :param noise: (B, U) uniform [0, 1) draws; pads are set to 2.0, so
        they are never taken
    :param sample_ratio: a float or a 0-dim fp32 tensor (the schedule)"""
    U = ys.shape[1]
    distance = (ys_hat != ys).sum(dim=1).float()
    sample_num = torch.ceil(sample_ratio * distance).long()
    pos = torch.arange(U, device=ys.device)[None, :]
    noise = torch.where(pos < ylens[:, None], noise, 2.0)
    rank = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1, stable=True)
    replace = rank < sample_num[:, None]
    return torch.where(replace[:, :, None], embed_ys, hs)
