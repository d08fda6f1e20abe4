"""Multi-head attention, absolute and relative-position (Transformer-XL),
full mode (liteasr_tpu/nets/attention.py).

Every attention goes through :func:`ops.flash_attention.flash_attention`:
on the card that is the CUDA kernel, on the CPU its plain version. The
reference's masks keep their shapes at this interface: (B, 1, 1, Tk)
suffix padding becomes per-row ``kv_lens``; any other mask is a structured
mask handed to the kernel per batch row (or per head, if it has H heads).
"""

from typing import Optional

import torch
from torch import nn

from liteasr_tpu_torch.nets.common import Dense, xavier_uniform_
from liteasr_tpu_torch.ops.flash_attention import flash_attention


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of {n_head} heads")
        self.n_head = n_head
        self.d_k = d_model // n_head
        self.linear_q = Dense(d_model, d_model, dtype=dtype, device=device)
        self.linear_k = Dense(d_model, d_model, dtype=dtype, device=device)
        self.linear_v = Dense(d_model, d_model, dtype=dtype, device=device)
        self.linear_o = Dense(d_model, d_model, dtype=dtype, device=device)

    def _heads(self, x):  # (B, T, D) -> (B, T, H, Dk)
        return x.reshape(x.shape[0], x.shape[1], self.n_head, self.d_k)

    def project_qkv(self, query, key, value):
        return (self._heads(self.linear_q(query)),
                self._heads(self.linear_k(key)),
                self._heads(self.linear_v(value)))

    def _attend(self, q, k, v, mask: Optional[torch.Tensor], rel_qv=None,
                rel_p=None):
        """q/k/v (B, T, H, Dk) -> fused attention -> (B, Tq, D) + out proj
        (the ``_flash`` mask handling of liteasr_tpu/nets/attention.py:57-94)."""
        B, Tq, H, Dk = q.shape
        Tk = k.shape[1]

        def fold(x):
            return x.transpose(1, 2).reshape(B * H, -1, Dk)

        kv_lens = None
        if mask is not None and mask.shape[-2] == 1:
            # (B, 1, 1, Tk) suffix padding -> (B*H,) lengths
            kv_lens = (~mask[:, 0, 0, :]).sum(dim=-1, dtype=torch.int32)
            kv_lens = kv_lens.repeat_interleave(H)
            mask = None
        elif mask is not None:  # (B, 1|H, 1|Tq, Tk) -> (B or B*H, Tq, Tk)
            h = mask.shape[1]
            mask = mask.expand(B, h, Tq, Tk).reshape(B * h, Tq, Tk)
        out = flash_attention(
            fold(q), fold(k), fold(v), mask=mask, kv_lens=kv_lens,
            rel_qv=None if rel_qv is None else fold(rel_qv),
            rel_p=rel_p, scale=Dk ** -0.5)
        out = out.reshape(B, H, Tq, Dk).transpose(1, 2).reshape(B, Tq, H * Dk)
        return self.linear_o(out)

    def forward(self, query, key, value, mask: Optional[torch.Tensor] = None):
        q, k, v = self.project_qkv(query, key, value)
        return self._attend(q, k, v, mask)


class RelativeMultiHeadAttention(MultiHeadAttention):
    """Rel-pos MHA with learnable content/position biases u, v
    (liteasr_tpu/nets/attention.py:228-381)."""

    def __init__(self, d_model: int, n_head: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(d_model, n_head, dtype=dtype, device=device)
        self.linear_pos = Dense(d_model, d_model, bias=False, dtype=dtype,
                                device=device)
        self.pos_bias_u = nn.Parameter(
            torch.zeros(n_head, self.d_k, device=device))
        self.pos_bias_v = nn.Parameter(
            torch.zeros(n_head, self.d_k, device=device))

    def reset_pos_bias(self, generator: Optional[torch.Generator]):
        xavier_uniform_(self.pos_bias_u, generator)
        xavier_uniform_(self.pos_bias_v, generator)

    def forward(self, query, key, value, pos_emb,
                mask: Optional[torch.Tensor] = None):
        q, k, v = self.project_qkv(query, key, value)
        # pos_emb is (1, T, D), shared across the batch: table (H, T, Dk)
        p = self._heads(self.linear_pos(pos_emb))[0].transpose(0, 1)
        q_u = q + self.pos_bias_u.to(q.dtype)
        q_v = q + self.pos_bias_v.to(q.dtype)
        return self._attend(q_u, k, v, mask, rel_qv=q_v, rel_p=p.contiguous())
