"""Train-mode BatchNorm with the closed-form backward
(liteasr_tpu/ops/batch_norm.py).

Statistics over every (B, T) position per channel, padded frames included
(the reference's convention), with the biased variance in fp32. The
backward is

    dx = gamma * rstd * (dy - mean(dy) - xhat * mean(dy * xhat))

one reduction pass over (dy, dy * xhat) and one elementwise pass; the
statistics it returns carry no gradient.
"""

import torch


class TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        x32 = x.float()
        n = x.shape[0] * x.shape[1]
        mean = x32.sum(dim=(0, 1)) / n
        var = torch.clamp(x32.square().sum(dim=(0, 1)) / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((x32 - mean) * rstd * gamma + beta).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, gamma)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, gamma = ctx.saved_tensors
        n = x.shape[0] * x.shape[1]
        dy32 = dy.float()
        xhat = (x.float() - mean) * rstd
        sum_dy = dy32.sum(dim=(0, 1))
        sum_dy_xhat = (dy32 * xhat).sum(dim=(0, 1))
        dx = (gamma * rstd) * (dy32 - sum_dy / n - xhat * (sum_dy_xhat / n))
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None


def train_batch_norm(x, gamma, beta, eps: float = 1e-5):
    """x (B, T, C) any float dtype; gamma/beta (C,) fp32. Returns (y, mean,
    var): y in x.dtype, fp32 batch mean and biased variance."""
    return TrainBatchNorm.apply(x, gamma, beta, eps)
