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

That loop is the plain version, which CPU tensors take. A CUDA tensor
launches the DP's two kernels (``csrc/rnnt_dp.cu``) or raises: one launch
for the forward, which keeps alpha for the backward, and one for the
backward, which runs the reverse variable beta and writes both gradients
in the same pass (:class:`LatticeNLL`). The kernels read each row's
lengths on the device, so nothing waits for the host.

Spans (``utils.tracing``, on only under a profiler): ``rnnt.lattice``
around :func:`lattice_log_probs` and ``rnnt.dp`` around the forward of
:func:`lattice_nll` (on the card, its one launch); the counter
``rnnt.lattice_cells`` takes each lattice's B x T x (U+1) x V, and
``rnnt.dp_kernel_rows`` / ``rnnt.dp_plain_rows`` the utterances whose DP
ran in the kernel or in the plain loop.
"""

import ctypes

import torch

from liteasr_tpu_torch.ops.cuda_libs import Library, check, launch, ptr
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
    U_b]) per utterance, (B,). The ``rnnt.dp`` span.

    A CPU tensor takes the plain loop; a CUDA tensor launches the kernel
    (``lattice_nll.launches``, and ``lattice_nll.bwd_launches`` for each
    backward), and keeps alpha only where a gradient is wanted."""
    rows = lp_blank.shape[0]
    with tracing.span("rnnt.dp", lp_blank.device):
        if lp_blank.device.type == "cpu":
            tracing.add("rnnt.dp_plain_rows", rows)
            return _lattice_nll(lp_blank, lp_emit, input_lengths, label_lengths)
        tracing.add("rnnt.dp_kernel_rows", rows)
        # the kernels read int64 lengths (the trainer's ids already are)
        lens = input_lengths.long(), label_lengths.long()
        if torch.is_grad_enabled() and (lp_blank.requires_grad or lp_emit.requires_grad):
            return LatticeNLL.apply(lp_blank, lp_emit, *lens)
        return _launch_fwd(lp_blank, lp_emit, *lens)[0]


lattice_nll.launches = 0
lattice_nll.bwd_launches = 0


class LatticeNLL(torch.autograd.Function):
    """The DP on the card: forward kernel, then the backward kernel on the
    saved alpha and loss. The lengths take no gradient."""

    @staticmethod
    def forward(ctx, lp_blank, lp_emit, input_lengths, label_lengths):
        loss, alpha = _launch_fwd(lp_blank, lp_emit, input_lengths, label_lengths)
        ctx.save_for_backward(lp_blank, lp_emit, input_lengths, label_lengths, alpha, loss)
        return loss

    @staticmethod
    def backward(ctx, grad):
        d_blank, d_emit = _launch_bwd(*ctx.saved_tensors, grad.float().contiguous())
        return d_blank, d_emit, None, None


def _dp_shape(lp_blank, lp_emit, input_lengths, label_lengths):
    """(B, T, U+1) of the kernels' inputs, checked: fp32 planes (B, T, U+1)
    and (B, T, U) with T >= 1, int64 lengths (B,)."""
    if lp_blank.dim() != 3 or lp_blank.shape[1] < 1:
        raise ValueError(f"lattice_nll: lp_blank must be (B, T >= 1, U+1), "
                         f"got {tuple(lp_blank.shape)}")
    if lp_blank.device.type != "cuda":
        raise ValueError(f"lattice_nll: unsupported device {lp_blank.device}")
    B, T, U1 = lp_blank.shape
    check("lattice_nll", lp_blank.device, ("lp_blank", lp_blank, torch.float32, (B, T, U1)),
          ("lp_emit", lp_emit, torch.float32, (B, T, U1 - 1)),
          ("input_lengths", input_lengths, torch.int64, (B,)),
          ("label_lengths", label_lengths, torch.int64, (B,)))
    return B, T, U1


# the DP's C entry points (csrc/rnnt_dp.cu)
_LIB = Library("rnnt_dp",
               rnnt_dp_fwd=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               rnnt_dp_bwd=[ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _launch_fwd(lp_blank, lp_emit, input_lengths, label_lengths):
    """The forward kernel: (loss (B,), alpha (B, T, U+1)), fp32."""
    B, T, U1 = _dp_shape(lp_blank, lp_emit, input_lengths, label_lengths)
    loss = torch.empty(B, dtype=torch.float32, device=lp_blank.device)
    alpha = torch.empty_like(lp_blank)
    if B:
        launch(_LIB.load().rnnt_dp_fwd, lp_blank.device, ptr(lp_blank), ptr(lp_emit),
               ptr(input_lengths), ptr(label_lengths), ptr(alpha), ptr(loss), B, T, U1 - 1)
        lattice_nll.launches += 1
    return loss, alpha


def _launch_bwd(lp_blank, lp_emit, input_lengths, label_lengths, alpha, loss, grad):
    """The backward kernel: fp32 (d lp_blank, d lp_emit) for the loss's
    cotangent ``grad`` (B,)."""
    B, T, U1 = _dp_shape(lp_blank, lp_emit, input_lengths, label_lengths)
    check("lattice_nll", lp_blank.device, ("alpha", alpha, torch.float32, (B, T, U1)),
          ("loss", loss, torch.float32, (B,)), ("grad", grad, torch.float32, (B,)))
    d_blank = torch.empty_like(lp_blank)
    d_emit = torch.empty_like(lp_emit)
    carry = torch.empty((B, T), dtype=torch.float32, device=lp_blank.device)
    if B:
        launch(_LIB.load().rnnt_dp_bwd, lp_blank.device, ptr(lp_blank), ptr(lp_emit),
               ptr(input_lengths), ptr(label_lengths), ptr(alpha), ptr(loss), ptr(grad),
               ptr(carry), ptr(d_blank), ptr(d_emit), B, T, U1 - 1)
        lattice_nll.bwd_launches += 1
    return d_blank, d_emit


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
