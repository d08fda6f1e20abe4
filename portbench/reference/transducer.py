"""Plain PyTorch conformer transducer (WeNet's AISHELL-1 conformer RNN-T as
the port defines it) for the benchmark's correctness check: its layout and
its train-mode loss with gradients. Functional, over a dict of fp32 leaves
named as the port's ``state_dict``; no kernel, no cache. Imports nothing of
the port.

* Encoder: the conformer of :mod:`reference.u2` (its layout's
  ``encoder.*`` leaves and :meth:`U2Reference.encode`).
* Prediction network: an embedding, then LSTM layers written out gate by
  gate (gates i, f, g, o; c' = f c + i g, h' = o tanh(c')), dropout on the
  embedding and after each layer.
* Joint: additive, tanh(lin_enc(h_enc) + lin_dec(h_dec)), then a linear
  to the vocabulary.
* Loss: -log P(y | x) by the published forward variable (Graves, 2012),
  alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
  alpha[t, u-1] + emit[t, u-1]), computed over the anti-diagonals t + u,
  summed over the real utterances and divided by their count.

Gradients come from autograd. :meth:`TransducerReference.loss_and_grads`
computes the joint and the loss in blocks of rows from detached copies of
the encoder's and the prediction network's outputs, runs each block
backward into them, then runs one backward through the encoder and the
prediction network: the fp32 lattice is never whole in memory.

``Ops("fp8")`` (:mod:`reference.u2`) rounds every product's operands to
float8, the control.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from reference import u2 as ref_u2
from weights import Layout

BLANK = 0
IGNORE = -1
NEG = -1e30  # log of zero, finite so that logaddexp's gradient stays finite
JOINT = ("lin_enc.weight", "lin_enc.bias", "lin_dec.weight", "lin_jnt.weight",
         "lin_jnt.bias")


def layout(m: Dict) -> Layout:
    """(name, shape, init) of every parameter: the conformer encoder's as
    :func:`reference.u2.layout` gives them, then the prediction network's
    and the joint's."""
    d, V, J = m["enc_dim"], m["vocab_size"], m["joint_dim"]
    E, H = m["dec_dim"], m["dec_units"]
    out: Layout = [e for e in ref_u2.layout(dict(m, dec_layers=0, dec_ff_dim=0))
                   if e[0].startswith("encoder.")]
    out.append(("decoder.embed.weight", (V, E), "normal1"))
    for i in range(m["dec_layers"]):
        p = f"decoder.rnn_{i}.cell"
        out.append((f"{p}.weight_ih", (4 * H, E if i == 0 else H), "normal"))
        out.append((f"{p}.weight_hh", (4 * H, H), "normal"))
        out.append((f"{p}.bias", (4 * H,), "zeros"))
    out += [("lin_enc.weight", (J, d), "normal"), ("lin_enc.bias", (J,), "zeros"),
            ("lin_dec.weight", (J, H), "normal"),
            ("lin_jnt.weight", (V, J), "normal"), ("lin_jnt.bias", (V,), "zeros")]
    return out


def rnnt_nll(blank: torch.Tensor, emit: torch.Tensor, t_len: torch.Tensor,
             u_len: torch.Tensor) -> torch.Tensor:
    """-log P(y | x) of each row, (B,), from the lattice's log-probabilities
    ``blank`` (B, T, U+1) and ``emit`` (B, T, U) (emit[t, u]: of label u+1
    at (t, u)), ``t_len`` frames and ``u_len`` labels a row.

    The forward variable over the anti-diagonals d = t + u: a diagonal is a
    vector over t, holding alpha[t, d - t]. From diagonal d - 1, a blank
    moves a cell to t + 1 and an emission keeps its t, so
    alpha_d[t] = logaddexp(alpha_{d-1}[t-1] + blank[t-1, d-t],
    alpha_{d-1}[t] + emit[t, d-t-1])."""
    B, T, U1 = blank.shape
    U = U1 - 1
    dev = blank.device
    t = torch.arange(T, device=dev)
    u = torch.arange(T + U, device=dev)[:, None] - t[None, :]  # (D, T): u of (d, t)
    in_grid = (u >= 0) & (u <= U)
    tt = t[None, :].expand_as(u)
    # each diagonal's cells' blank and emission scores, (B, D, T)
    blank_d = torch.where(in_grid, blank[:, tt, u.clamp(0, U)], NEG)
    if U > 0:
        emit_d = torch.where(in_grid & (u < U), emit[:, tt, u.clamp(0, U - 1)], NEG)
    else:
        emit_d = torch.full_like(blank_d, NEG)
    # diagonal 0: alpha[0, 0] = 0
    alpha = torch.where(t == 0, 0.0, NEG).to(blank.dtype).expand(B, T)
    alphas = [alpha]
    edge = torch.full((B, 1), NEG, dtype=blank.dtype, device=dev)
    for d in range(1, T + U):
        by_blank = torch.cat([edge, (alpha + blank_d[:, d - 1])[:, :-1]], dim=1)
        by_emit = alpha + emit_d[:, d - 1]
        alpha = torch.where(in_grid[d], torch.logaddexp(by_blank, by_emit), NEG)
        alphas.append(alpha)
    rows = torch.arange(B, device=dev)
    t_last, u_len = t_len.long() - 1, u_len.long()
    final = torch.stack(alphas, dim=1)[rows, t_last + u_len, t_last]
    return -(final + blank[rows, t_last, u_len])


def row_blocks(t_len: torch.Tensor, u_len: torch.Tensor, vocab: int, cells: Optional[int]):
    """Slices of consecutive rows whose lattices, cut to the block's longest
    ``t_len`` and ``u_len``, hold at most ``cells`` cells (a row alone may
    hold more); one slice of every row for None."""
    tl, ul = t_len.tolist(), u_len.tolist()
    start = 0
    while start < len(tl):
        stop, T, U = start + 1, tl[start], ul[start]
        while stop < len(tl):
            T2, U2 = max(T, tl[stop]), max(U, ul[stop])
            if cells is not None and (stop + 1 - start) * T2 * (U2 + 1) * vocab > cells:
                break
            stop, T, U = stop + 1, T2, U2
        yield slice(start, stop)
        start = stop


class TransducerReference:
    """The train-mode loss over leaves ``P``, with the step's draws: ``drop``
    (the plain dropouts' masks, ``draws.Dropouts``) and ``attn_seeds`` (the
    attention kernels' hash seeds, ``draws.SeedStream``)."""

    def __init__(self, m: Dict, ops: ref_u2.Ops):
        self.m, self.ops = m, ops
        self.encoder = ref_u2.U2Reference(m, ops)
        self.dec_rate = float(m["dec_dropout_rate"])

    def lstm(self, P, name, x):
        """One LSTM layer over x (B, L, in) from a zero carry -> (B, L, H)."""
        w_ih, w_hh = P[f"{name}.weight_ih"], P[f"{name}.weight_hh"]
        gates_in = self.ops.matmul(x, w_ih.t()) + P[f"{name}.bias"]
        h = c = x.new_zeros(x.shape[0], w_hh.shape[1])
        out = []
        for step in range(x.shape[1]):
            gates = gates_in[:, step] + self.ops.matmul(h, w_hh.t())
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)

    def predict(self, P, ys_in, drop=None):
        """The prediction network's output (B, U+1, H) over ``ys_in``."""
        def dropped(h):
            return drop(h, self.dec_rate) if drop is not None else h

        h = dropped(F.embedding(ys_in, P["decoder.embed.weight"]))
        for i in range(self.m["dec_layers"]):
            h = dropped(self.lstm(P, f"decoder.rnn_{i}.cell", h))
        return h

    def joint_nll(self, P, h_enc, h_dec, targets, t_len, u_len):
        """-log P(y | x) of rows whose encoder output ``h_enc`` (b, T', D) and
        prediction ``h_dec`` (b, U+1, H) are given, over the lattice cut to
        the rows' longest ``t_len`` and ``u_len``."""
        T, U = int(t_len.max()), int(u_len.max())
        z = (self.ops.linear(h_enc[:, :T], P, "lin_enc")[:, :, None]
             + self.ops.linear(h_dec[:, :U + 1], P, "lin_dec", bias=False)[:, None])
        logp = torch.log_softmax(self.ops.linear(torch.tanh(z), P, "lin_jnt"), dim=-1)
        index = targets[:, None, :U, None].expand(-1, T, U, 1)
        emit = torch.gather(logp[:, :, :U], 3, index)[..., 0]
        return rnnt_nll(logp[..., BLANK], emit, t_len, u_len)

    def loss_and_grads(self, P, batch, drop, attn_seeds, cells: Optional[int] = None):
        """The batch's loss (a float) and every leaf's gradient. The joint
        and the loss run in blocks of consecutive rows of at most ``cells``
        lattice cells (one block for None)."""
        xs, xlens, ys, ylens = batch["xs"], batch["xlens"], batch["ys"], batch["ylens"]
        valid = batch["valid"]
        nutt = torch.clamp(valid.sum(), min=1.0)
        h_enc, _ = self.encoder.encode(P, xs, xlens, drop, attn_seeds)
        targets = torch.where(ys == IGNORE, BLANK, ys).long()
        ys_in = torch.cat([torch.full_like(targets[:, :1], BLANK), targets], dim=1)
        h_dec = self.predict(P, ys_in, drop)
        t_len = ((xlens - 1) // 2 - 1) // 2
        enc, dec = h_enc.detach().requires_grad_(True), h_dec.detach().requires_grad_(True)
        joint = [P[n] for n in JOINT]
        grads = [torch.zeros_like(x) for x in [enc, dec] + joint]
        total = 0.0
        for rows in row_blocks(t_len, ylens, self.m["vocab_size"], cells):
            nll = self.joint_nll(P, enc[rows], dec[rows], targets[rows], t_len[rows],
                                 ylens[rows])
            loss = (nll * valid[rows]).sum() / nutt
            for acc, g in zip(grads, torch.autograd.grad(loss, [enc, dec] + joint)):
                acc += g
            total += float(loss.detach())
            del nll, loss
        leaves = [n for n in P if n not in JOINT]
        back = torch.autograd.grad([h_enc, h_dec], [P[n] for n in leaves],
                                   grad_outputs=grads[:2], allow_unused=True)
        out = {n: (torch.zeros_like(P[n]) if g is None else g) for n, g in zip(leaves, back)}
        out.update(zip(JOINT, grads[2:]))
        return total, out
