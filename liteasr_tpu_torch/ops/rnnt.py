"""RNN-T (transducer) loss: the log-space lattice DP of liteasr_tpu/ops/rnnt.py.

The forward variable obeys

    alpha[t, u] = logadd(alpha[t-1, u] + blank[t-1, u],
                         alpha[t,   u-1] + emit[t, u-1])

The in-row recursion (u-1 -> u at fixed t) is closed in one step: with
c[u] = alpha[t-1, u] + blank[t-1, u] and Y[u] = cumsum(emit[t, :u]),

    alpha[t, u] = Y[u] + logcumsumexp(c - Y)[u]

so the only sequential loop is the one over T (JAX's ``lax.scan``; a Python
loop here). ``torch.logcumsumexp`` is JAX's ``associative_scan(logaddexp)``.
Gradients come from autograd through the loop, as JAX's come from autodiff
through the scan.

loss[b] = -(alpha[T_b-1, U_b] + blank[T_b-1, U_b])

Spans (``utils.tracing``, on only under a profiler): ``rnnt.lattice``
around :func:`lattice_log_probs` and ``rnnt.dp`` around the forward of
:func:`lattice_nll`; the counter ``rnnt.lattice_cells`` takes each
lattice's B x T x (U+1) x V.
"""

import torch

from liteasr_tpu_torch.utils import tracing

NEG_INF = -1e30


def lattice_log_probs(logits: torch.Tensor, targets: torch.Tensor, blank: int = 0):
    """The two slices of the lattice's log-softmax that the DP reads, in fp32:
    (lp_blank (B, T, U+1), lp_emit (B, T, U)). log p[v] = h[v] - lse(h); the
    lse is taken over V in fp32, and only the blank and target-label scores
    are gathered (liteasr_tpu/ops/rnnt.py:48-59). The ``rnnt.lattice`` span."""
    B, T, U1, _ = logits.shape
    U = U1 - 1
    if targets.shape[1] != U:
        raise ValueError(f"targets {tuple(targets.shape)} against the lattice "
                         f"{tuple(logits.shape)}")
    tracing.add("rnnt.lattice_cells", logits.numel())
    with tracing.span("rnnt.lattice", logits.device):
        lse = torch.logsumexp(logits.float(), dim=-1)  # (B, T, U+1)
        lp_blank = logits[..., blank].float() - lse
        index = targets.long()[:, None, :, None].expand(B, T, U, 1)
        lp_emit = torch.gather(logits[:, :, :U, :], 3, index)[..., 0].float() - lse[:, :, :U]
    return lp_blank, lp_emit


def lattice_nll(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                input_lengths: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """The forward DP over the lattice: -(alpha[T_b-1, U_b] + blank[T_b-1,
    U_b]) per utterance, (B,). The ``rnnt.dp`` span."""
    with tracing.span("rnnt.dp", lp_blank.device):
        return _lattice_nll(lp_blank, lp_emit, input_lengths, label_lengths)


def _lattice_nll(lp_blank, lp_emit, input_lengths, label_lengths):
    B, T, U1 = lp_blank.shape
    U = U1 - 1
    dev = lp_blank.device
    label_lengths = label_lengths.long()
    input_lengths = input_lengths.long()
    u_idx = torch.arange(U1, device=dev)[None, :]
    live = u_idx <= label_lengths[:, None]  # (B, U+1) reachable lattice columns
    emit_live = u_idx[:, :U] < label_lengths[:, None]  # (B, U)
    floor = torch.tensor(NEG_INF, device=dev)
    zero_col = torch.zeros((B, 1), device=dev)

    def row_close(alpha_in, emit_t):
        """alpha_out[u] = logsumexp_{k<=u} (alpha_in[k] + sum_{j=k}^{u-1} emit_t[j])."""
        safe_emit = torch.where(emit_live, emit_t, 0.0)  # dead columns never used
        ycum = torch.cat([zero_col, torch.cumsum(safe_emit, dim=1)], dim=1)
        vals = torch.where(live, alpha_in - ycum, NEG_INF)
        out = ycum + torch.logcumsumexp(vals, dim=1)
        # torch.maximum splits the gradient of a tie as jnp.maximum does
        return torch.where(live, torch.maximum(out, floor), NEG_INF)

    # t = 0: only emissions from alpha[0, 0] = 0
    alpha0 = torch.full((B, U1), NEG_INF, device=dev)
    alpha0[:, 0] = 0.0
    alpha = row_close(alpha0, lp_emit[:, 0])
    for t in range(1, T):
        new_alpha = row_close(alpha + lp_blank[:, t - 1], lp_emit[:, t])
        alpha = torch.where((t < input_lengths)[:, None], new_alpha, alpha)

    final_alpha = alpha.gather(1, label_lengths[:, None])[:, 0]
    t_last = torch.clamp(input_lengths - 1, 0, T - 1)
    final_blank = lp_blank[torch.arange(B, device=dev), t_last, label_lengths]
    return -(final_alpha + final_blank)


def rnnt_loss(logits: torch.Tensor, targets: torch.Tensor,
              input_lengths: torch.Tensor, label_lengths: torch.Tensor,
              blank: int = 0) -> torch.Tensor:
    """Per-utterance negative log-likelihood, shape (B,).

    :param logits: (B, T, U+1, V) joint network output (pre-softmax)
    :param targets: (B, U) label ids (no blanks)
    :param input_lengths: (B,) valid encoder frames
    :param label_lengths: (B,) valid labels
    """
    lp_blank, lp_emit = lattice_log_probs(logits, targets, blank)
    return lattice_nll(lp_blank, lp_emit, input_lengths, label_lengths)
