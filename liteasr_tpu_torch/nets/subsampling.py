"""Conv2D subsampling front end: T -> ((T-1)//2-1)//2
(liteasr_tpu/nets/subsampling.py).

The reference convolves channel-last, (B, T, F, 1), and flattens
(B, T', F', C) with F' major. torch convolves channel-first, so the
(B, C, T', F') output is permuted to (B, T', F', C) before the flatten;
otherwise ``out`` would see its input columns permuted. The reference's
``dropout_rate`` field is never applied, so the train forward is this one.
"""

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.nets.common import Dense


def subsampled_length(t: int) -> int:
    return ((t - 1) // 2 - 1) // 2


class Conv2DSubsampling(nn.Module):
    def __init__(self, in_dim: int, o_dim: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        kw = dict(device=device, dtype=torch.float32)
        self.conv1 = nn.Conv2d(1, o_dim, 3, stride=2, **kw)
        self.conv2 = nn.Conv2d(o_dim, o_dim, 3, stride=2, **kw)
        f_sub = subsampled_length(in_dim)
        self.out = Dense(o_dim * f_sub, o_dim, dtype=dtype, device=device)

    def _conv(self, conv, x):
        dt = self.compute_dtype
        return F.relu(F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                               stride=conv.stride))

    def forward(self, x):
        x = self._conv(self.conv1, x[:, None])  # (B, C, T', F')
        x = self._conv(self.conv2, x)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        return self.out(x)
