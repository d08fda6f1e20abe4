"""LSTM prediction network of the transducer (liteasr_tpu/nets/rnn_decoder.py).

Embedding -> N LSTM layers, dropout on the embedding and after every layer.
Each layer is flax's ``OptimizedLSTMCell``: gates i, f, g, o; carry
``(c, h)`` in that order; c' = f c + i g, h' = o tanh(c'). flax keeps one
bias per gate (on the recurrent side), so a layer holds exactly one
trainable bias: ``weight_ih`` (4H, in), ``weight_hh`` (4H, H) and ``bias``
(4H,), packed in gate order i, f, g, o. The torch LSTM calls take a second
bias; a zero buffer fills that place, so Adam steps the effective bias as
flax does, not at twice its rate.

``forward`` runs whole sequences through ``torch.lstm`` (cuDNN on the card);
``init_state`` and ``step`` serve decoding through ``torch.lstm_cell``. Both
compute in the model's dtype. The JAX package computes the recurrence in XLA
(``nn.RNN``, a ``lax.scan``); its bf16 carry rounds otherwise than cuDNN's,
so the two agree exactly only in fp32.
"""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.nets.common import dropout, lecun_normal_

State = List[Tuple[torch.Tensor, torch.Tensor]]


class LSTMCell(nn.Module):
    """One ``OptimizedLSTMCell`` with its four gates packed (i, f, g, o)."""

    def __init__(self, in_features: int, units: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.units = units
        self.compute_dtype = dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * units, in_features, device=device))
        self.weight_hh = nn.Parameter(torch.empty(4 * units, units, device=device))
        self.bias = nn.Parameter(torch.zeros(4 * units, device=device))
        self.register_buffer("zero_bias", torch.zeros(4 * units, device=device),
                             persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers: lecun-normal input kernels, an orthogonal
        (H, H) recurrent kernel per gate, zero biases; then the forget
        gate's bias 1 (``forget_bias_ones``)."""
        lecun_normal_(self.weight_ih, self.weight_ih.shape[1], generator)
        for w in self.weight_hh.split(self.units):
            # flax draws a (H, H) kernel and applies x @ kernel: ours is its
            # transpose, which is orthogonal as well
            nn.init.orthogonal_(w, generator=generator)
        self.bias.zero_()
        self.bias[self.units:2 * self.units] = 1.0

    def weights(self):
        dt = self.compute_dtype
        return (self.weight_ih.to(dt), self.weight_hh.to(dt), self.bias.to(dt),
                self.zero_bias.to(dt))

    def forward(self, x, carry: Tuple[torch.Tensor, torch.Tensor]):
        """One step: x (B, in), carry (c, h) -> (new carry, h')."""
        c, h = carry
        h_new, c_new = torch.lstm_cell(x.to(self.compute_dtype), (h, c), *self.weights())
        return (c_new, h_new), h_new

    def sequence(self, x):
        """A whole sequence from a zero carry: x (B, L, in) -> (B, L, H)."""
        dt = self.compute_dtype
        zeros = x.new_zeros((1, x.shape[0], self.units), dtype=dt)
        out, _, _ = torch.lstm(x.to(dt), (zeros, zeros), self.weights(), True, 1,
                               0.0, torch.is_grad_enabled(), False, True)
        return out


class RNNDecoder(nn.Module):
    def __init__(self, vocab_size: int, h_dim: int, h_units: int, n_layer: int,
                 dropout_rate: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.h_units = h_units
        self.n_layer = n_layer
        self.dropout_rate = dropout_rate
        self.embed = nn.Embedding(vocab_size, h_dim, device=device, dtype=torch.float32)
        for i in range(n_layer):
            rnn = nn.Module()
            rnn.cell = LSTMCell(h_dim if i == 0 else h_units, h_units,
                                dtype=dtype, device=device)
            self.add_module(f"rnn_{i}", rnn)

    def cells(self) -> List[LSTMCell]:
        return [getattr(self, f"rnn_{i}").cell for i in range(self.n_layer)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0, 1) embeddings (liteasr_tpu/nets/rnn_decoder.py:32-34) and
        flax's LSTM initializers with forget bias 1."""
        self.embed.weight.normal_(0.0, 1.0, generator=generator)
        for cell in self.cells():
            cell.reset_parameters(generator)

    def _embed(self, ys):
        return F.embedding(ys, self.embed.weight.to(self.compute_dtype))

    def forward(self, ys, train: bool = False):
        """:param ys: (B, L) token ids -> (B, L, h_units)."""
        h = dropout(self._embed(ys), self.dropout_rate, train)
        for cell in self.cells():
            h = dropout(cell.sequence(h), self.dropout_rate, train)
        return h

    def init_state(self, batch: int, device=None) -> State:
        """Zero (c, h) carries in the compute dtype, one per layer."""
        device = device if device is not None else self.embed.weight.device
        zeros = torch.zeros((batch, self.h_units), dtype=self.compute_dtype,
                            device=device)
        return [(zeros, zeros) for _ in range(self.n_layer)]

    def step(self, tok, state: State):
        """One decode step: tok (B,) ids -> (out (B, h_units), new state)."""
        h = self._embed(tok)
        new_state = []
        for cell, carry in zip(self.cells(), state):
            carry, h = cell(h, carry)
            new_state.append(carry)
        return h, new_state
