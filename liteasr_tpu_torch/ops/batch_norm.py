"""Train-mode BatchNorm with the closed-form backward
(liteasr_tpu/ops/batch_norm.py).

Statistics over every (B, T) position per channel, padded frames included
(the reference's convention), with the biased variance in fp32. The
backward is

    dx = gamma * rstd * (dy - mean(dy) - xhat * mean(dy * xhat))

one reduction pass over (dy, dy * xhat) and one elementwise pass; the
statistics it returns carry no gradient.

Under a process group the statistics are the global batch's, as under the
JAX package's dp and sp sharding: the forward all-reduces the channel sums
of x and x^2 over the dp x sp group, and the backward sum(dy) and
sum(dy * xhat) to form dx. The frame count is a host number: the rank's
rows times the full time axis (``frames``, the sp block's whole; the
rank's own without sp) times dp, since the collator pads every dp rank's
block to one shape and sp blocks may be uneven. dgamma and dbeta stay this
rank's sums: the optimizer's gradient all-reduce adds the ranks' shares,
so returning the global sums would count them once per rank. Under tensor
parallelism x holds the rank's channels, and so do the statistics.
"""

from typing import Optional

import torch

from liteasr_tpu_torch import parallel


class TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, frames: Optional[int] = None):
        x32 = x.float()
        n = x.shape[0] * x.shape[1]
        s1, s2 = x32.sum(dim=(0, 1)), x32.square().sum(dim=(0, 1))
        if parallel.is_initialized():
            c = s1.shape[0]
            stats = parallel.global_sum_(torch.cat([s1, s2]), "batch_norm")
            s1, s2 = stats[:c], stats[c:]
            # every dp rank holds a block of the same shape (the collator
            # pads the global batch) and the sp blocks make up the time
            # axis, so the global count is known here; a host number also
            # keeps the division the one-process step's
            n = x.shape[0] * (frames or x.shape[1]) * parallel.layout().dp
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((x32 - mean) * rstd * gamma + beta).to(x.dtype)
        ctx.n = n
        ctx.save_for_backward(x, mean, rstd, gamma)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, gamma = ctx.saved_tensors
        n = ctx.n
        dy32 = dy.float()
        xhat = (x.float() - mean) * rstd
        sum_dy = dy32.sum(dim=(0, 1))
        sum_dy_xhat = (dy32 * xhat).sum(dim=(0, 1))
        g_dy, g_dy_xhat = sum_dy, sum_dy_xhat
        if parallel.is_initialized():
            c = sum_dy.shape[0]
            sums = parallel.global_sum_(torch.cat([sum_dy, sum_dy_xhat]), "batch_norm")
            g_dy, g_dy_xhat = sums[:c], sums[c:]
        dx = (gamma * rstd) * (dy32 - g_dy / n - xhat * (g_dy_xhat / n))
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None


def train_batch_norm(x, gamma, beta, eps: float = 1e-5, frames: Optional[int] = None):
    """x (B, T, C) any float dtype; gamma/beta (C,) fp32; ``frames`` the
    full time axis when x is an sp rank's block. Returns (y, mean, var): y
    in x.dtype, fp32 batch mean and biased variance."""
    return TrainBatchNorm.apply(x, gamma, beta, eps, frames)
