"""Multi-head attention, absolute and relative-position (Transformer-XL)
(liteasr_tpu/nets/attention.py).

The streaming encoders' chunk policy, ``triangle_mask(stage=chunk)``, is
not a mask here but the integer ``chunk`` (0 = none) beside the padding
mask: the kernels compute it from the indices.

Eval mode: every attention goes through
:func:`ops.flash_attention.flash_attention` (K1): on the card that is the
CUDA kernel, on the CPU its plain version. The reference's masks keep their
shapes at this interface: (B, 1, 1, Tk) suffix padding becomes per-row
``kv_lens``; any other mask is a structured mask handed to the kernel per
batch row (or per head, if it has H heads); ``chunk`` goes to the kernel.

Train mode: rel-pos self-attention with a padding mask (or none) and a
chunk width goes through K3, :func:`ops.flash_attention.
flash_rel_attention_train` (the kernels K1' and K2 on the card), with
attention dropout from the kernel's counter hash seeded from the layer's
``generator``; any other structured mask raises. The generator draws the
same seeds on every rank of a process group; the seed is moved to the
rank's first row of the global batch (``dropout_seed_at_row``), so that
each row keeps the mask it has in a one-process run. The absolute-position
attention, like the reference, computes its scores, fp32 softmax, dropout
and context in plain PyTorch (``apply_attention``,
liteasr_tpu/nets/attention.py:35-44).

Tensor parallelism (``tp``, set by ``parallel.sharding.shard_model``): the
module holds heads ``head0 ..`` (``n_head`` of ``h_total``), q/k/v and
``linear_pos`` column-parallel behind ``copy_to_tp``, ``linear_o``
row-parallel; the kernels' dropout hash folds the full call's row, and the
plain attention's dropout draws from the "tp" stream. Sequence parallelism
(``seq``, a ``parallel.sharding.SeqShard``): the module gets the rank's
block of query frames; K and V are gathered over the sp group, the
positional table is the whole one, and the rel-pos q_v rows carry the next
block's first row (the legacy crossover), gathered with them; the kernels
run at the block's query offset.

Cached decoding: the decoder's ``step_self``/``step_src`` and the
streaming encoders' ``chunk_step`` (mode ``chunk``, :146-161 and the rel-pos
``_chunk`` :295-337) are plain PyTorch, as the reference's are XLA code;
they write the preallocated K/V caches in place.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.nets.common import Dense, dropout, xavier_uniform_
from liteasr_tpu_torch.ops.flash_attention import (
    WHOLE, Shard, chunk_mask, dropout_seed_at_row, flash_attention,
    flash_rel_attention_train)
from liteasr_tpu_torch.parallel import sharding

MASK_FILL = -1e38  # the reference's masked score in plain attention


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, dropout_rate: float = 0.0,
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of {n_head} heads")
        self.n_head = n_head
        self.d_k = d_model // n_head
        # tensor parallelism: heads head0 .. head0 + n_head of h_total
        self.tp = False
        self.head0, self.h_total = 0, n_head
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.linear_q = Dense(d_model, d_model, dtype=dtype, device=device)
        self.linear_k = Dense(d_model, d_model, dtype=dtype, device=device)
        self.linear_v = Dense(d_model, d_model, dtype=dtype, device=device)
        self.linear_o = Dense(d_model, d_model, dtype=dtype, device=device)

    def _heads(self, x):  # (B, T, D) -> (B, T, H, Dk)
        return x.reshape(x.shape[0], x.shape[1], self.n_head, self.d_k)

    def project_qkv(self, query, key, value):
        if self.tp:
            query, key, value = sharding.copy_inputs_to_tp(query, key, value)
        return (self._heads(self.linear_q(query)),
                self._heads(self.linear_k(key)),
                self._heads(self.linear_v(value)))

    def _kernel_shard(self, seq: Optional[sharding.SeqShard]) -> Shard:
        """Where this module's kernel calls lie in the full attention."""
        if not self.tp and seq is None:
            return WHOLE
        return Shard(q0=seq.lo if seq else 0, t_q=seq.total if seq else 0,
                     head0=self.head0, h_local=self.n_head, h_total=self.h_total)

    @staticmethod
    def _gather_kv(k, v, seq: Optional[sharding.SeqShard]):
        """Every sp rank's keys and values, in one gather."""
        if seq is None:
            return k, v
        kv = sharding.gather_from_sp(torch.cat([k, v], dim=-1), 1, seq.sizes)
        return kv.split(k.shape[-1], dim=-1)

    def _attend(self, q, k, v, mask: Optional[torch.Tensor], rel_qv=None,
                rel_p=None, chunk: int = 0, shard: Shard = WHOLE):
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
            rel_p=rel_p, scale=Dk ** -0.5, chunk=chunk, shard=shard)
        out = out.reshape(B, H, Tq, Dk).transpose(1, 2).reshape(B, Tq, H * Dk)
        return self.linear_o(out)

    def apply_attention(self, scores, v, mask: Optional[torch.Tensor],
                        train: bool):
        """scores (B, H, Tq, Tk) fp32, v (B, Tk, H, Dk) -> masked softmax ->
        dropout -> context -> out proj (liteasr_tpu/nets/attention.py:35-44)."""
        if mask is not None:
            scores = scores.masked_fill(mask, MASK_FILL)
        attn = torch.softmax(scores, dim=-1).to(self.compute_dtype)
        attn = dropout(attn, self.dropout_rate, train, stream="tp" if self.tp else None)
        x = torch.einsum("bhqk,bkhd->bqhd", attn, v.to(self.compute_dtype))
        return self.linear_o(x.reshape(x.shape[0], x.shape[1], -1))

    def _plain(self, q, k, v, mask: Optional[torch.Tensor], train: bool):
        """The reference's XLA attention: fp32 scores by einsum, then
        :meth:`apply_attention`."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        return self.apply_attention(scores * self.d_k ** -0.5, v, mask, train)

    def forward(self, query, key, value, mask: Optional[torch.Tensor] = None,
                train: bool = False, chunk: int = 0,
                seq: Optional[sharding.SeqShard] = None):
        """``seq``: the self-attention of the rank's block of frames under
        sequence parallelism (keys and values gathered)."""
        q, k, v = self.project_qkv(query, key, value)
        k, v = self._gather_kv(k, v, seq)
        if not train:
            return self._attend(q, k, v, mask, chunk=chunk, shard=self._kernel_shard(seq))
        if chunk > 0:  # the reference's XLA path takes the materialized mask
            cm = chunk_mask(q.shape[1], k.shape[1], chunk, q.device,
                            seq.lo if seq else 0)[None, None]
            mask = cm if mask is None else mask | cm
        return self._plain(q, k, v, mask, train)

    # ---- cached decoding (liteasr_tpu/nets/attention.py:112-144), plain
    # like the reference's; the same parameters as forward

    def prime_kv(self, memory) -> Tuple[torch.Tensor, torch.Tensor]:
        """``mode="prime_kv"``: the memory's K and V, (B, Tk, H, Dk),
        projected once for every decode step."""
        return self._heads(self.linear_k(memory)), self._heads(self.linear_v(memory))

    def step_src(self, query, src_kv, mask: Optional[torch.Tensor]):
        """``mode="step_src"``: the (B, 1, D) query against the primed
        ``src_kv``; ``mask`` (B, 1, 1, Tk) or None."""
        return self._plain(self._heads(self.linear_q(query)), *src_kv, mask, False)

    def step_self(self, query, cache, index: int):
        """``mode="step_self"``: the (B, 1, D) token at position ``index``.
        ``cache`` is (k, v), each (B, L, H, Dk); its row ``index`` is
        written in place, and the rows past it (stale) are masked."""
        q, k_t, v_t = self.project_qkv(query, query, query)
        k, v = self._write_cache(cache, k_t, v_t, index)
        future = (torch.arange(k.shape[1], device=k.device) > index)[None, None, None, :]
        return self._plain(q, k, v, future, False)

    def _write_cache(self, cache, k_t, v_t, index: int):
        """Rows ``index`` .. ``index + c`` of the (k, v) caches, in place."""
        k, v = cache
        c = k_t.shape[1]
        k[:, index:index + c] = k_t.to(k.dtype)
        v[:, index:index + c] = v_t.to(v.dtype)
        return k, v

    def chunk_step(self, query, cache, index: int, mask: torch.Tensor):
        """``mode="chunk"``, the streaming encoder's self-attention: the
        (B, c, D) chunk at stream position ``index`` against the cache of
        everything seen so far, written in place at ``index``; ``mask``
        (B, 1, c, L) hides the chunk policy's keys and the unwritten tail."""
        q, k_t, v_t = self.project_qkv(query, query, query)
        k, v = self._write_cache(cache, k_t, v_t, index)
        return self._plain(q, k, v, mask, False)


class RelativeMultiHeadAttention(MultiHeadAttention):
    """Rel-pos MHA with learnable content/position biases u, v
    (liteasr_tpu/nets/attention.py:228-381). ``generator`` (CPU) draws the
    int32 seed of the kernels' dropout hash, one per train-mode call
    (:meth:`draw_seed`)."""

    def __init__(self, d_model: int, n_head: int, dropout_rate: float = 0.0,
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(d_model, n_head, dropout_rate, dtype=dtype,
                         device=device)
        self.linear_pos = Dense(d_model, d_model, bias=False, dtype=dtype,
                                device=device)
        self.pos_bias_u = nn.Parameter(
            torch.zeros(n_head, self.d_k, device=device))
        self.pos_bias_v = nn.Parameter(
            torch.zeros(n_head, self.d_k, device=device))
        self.generator = torch.Generator()

    def reset_pos_bias(self, generator: Optional[torch.Generator]):
        xavier_uniform_(self.pos_bias_u, generator)
        xavier_uniform_(self.pos_bias_v, generator)

    def draw_seed(self) -> int:
        """The int32 seed of one train-mode call's dropout hash, from
        ``generator`` (0 without dropout: nothing is drawn)."""
        if self.dropout_rate <= 0.0:
            return 0
        return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=self.generator))

    def _flash_train(self, q_u, q_v, k, v, p, mask, seed: Optional[int],
                     chunk: int = 0, shard: Shard = WHOLE):
        """(B, T, H, Dk) heads -> K3 -> out proj (``_flash_train``,
        liteasr_tpu/nets/attention.py:248-293). ``mask`` is None or
        (B, 1, 1, Tk) suffix padding, compressed to per-row lengths;
        ``chunk`` the chunk width. ``seed`` None draws one. ``shard``: the
        call's place in the full attention (heads, query block)."""
        B, Tq, H, Dk = q_u.shape

        def fold(x):
            return x.transpose(1, 2).reshape(B * H, -1, Dk)

        kv_lens = None
        if mask is not None:
            kv_lens = (~mask[:, 0, 0, :]).sum(dim=-1, dtype=torch.int32)
            kv_lens = kv_lens.repeat_interleave(H)
        if seed is None:
            seed = self.draw_seed()
        dp_i = parallel.layout().dp_i
        if dp_i:  # dp rank i holds the global batch's rows i B .. (all heads)
            seed = dropout_seed_at_row(seed, dp_i * B * self.h_total)
        out = flash_rel_attention_train(
            fold(q_u), fold(q_v), fold(k), fold(v), p, kv_lens, seed,
            Dk ** -0.5, self.dropout_rate, chunk, shard)
        out = out.reshape(B, H, Tq, Dk).transpose(1, 2)
        return self.linear_o(out.to(self.compute_dtype).reshape(B, Tq, H * Dk))

    def _biased_queries(self, q):
        return q + self.pos_bias_u.to(q.dtype), q + self.pos_bias_v.to(q.dtype)

    def forward(self, query, key, value, pos_emb,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                dropout_seed: Optional[int] = None, chunk: int = 0,
                seq: Optional[sharding.SeqShard] = None):
        """``dropout_seed``: the kernels' dropout seed of a train-mode call
        drawn by the caller (a rematerialized layer draws it once, outside
        the recomputed region, so that the recompute regenerates the same
        mask); None draws it here. ``chunk``: the chunk width (0 = none).
        ``seq``: the rank's block of query frames under sequence
        parallelism; ``pos_emb`` is then the whole table."""
        q, k, v = self.project_qkv(query, key, value)
        # pos_emb is (1, T, D), shared across the batch: table (H, T, Dk)
        p = self._heads(self.linear_pos(pos_emb))[0].transpose(0, 1)
        q_u, q_v = self._biased_queries(q)
        if seq is not None:
            k, v = self._gather_kv(k, v, seq)
            # the crossover: q_v gets the next block's first row, the last
            # block a zero row that no score reads (every rank takes part
            # in the gather and in its backward)
            n = len(seq.sizes)
            firsts = sharding.gather_from_sp(q_v[:, :1], 1, (1,) * n)
            nxt = firsts[:, (seq.index + 1) % n].unsqueeze(1)
            q_v = torch.cat([q_v, nxt * 0 if seq.last else nxt], dim=1)
        shard = self._kernel_shard(seq)
        if not train:
            return self._attend(q_u, k, v, mask, rel_qv=q_v,
                                rel_p=p.contiguous(), chunk=chunk, shard=shard)
        if mask is not None and mask.shape[1:3] != (1, 1):
            raise NotImplementedError(
                "train-mode rel-pos attention takes a (B, 1, 1, T) padding "
                "mask and a chunk width; the kernels have no other "
                f"structured mask (got {tuple(mask.shape)})")
        return self._flash_train(q_u, q_v, k, v, p.contiguous(), mask,
                                 dropout_seed, chunk, shard=shard)

    def chunk_step(self, query, pos_emb, cache, index: int, mask: torch.Tensor,
                   align: Tuple[torch.Tensor, torch.Tensor]):
        """The rel-pos ``_chunk`` (liteasr_tpu/nets/attention.py:295-337):
        the (B, c, D) chunk at stream position ``index`` against the cache,
        written in place, with the offline ``rel_shift`` read from the
        (1, Lp, D) table through ``align`` (:func:`rel_chunk_align`, built
        once per step for every layer). The (c, Lp) products are one einsum,
        the alignment one flat gather."""
        q, k_t, v_t = self.project_qkv(query, query, query)
        B, c, H, Dk = q.shape
        p = self._heads(self.linear_pos(pos_emb))[0]  # (Lp, H, Dk)
        q_u, q_v = self._biased_queries(q)
        k, v = self._write_cache(cache, k_t, v_t, index)
        Lk = k.shape[1]
        flat, zero = align
        ac = torch.einsum("bqhd,bkhd->bhqk", q_u.float(), k.float())
        bd_all = torch.einsum("bqhd,khd->bhqk", q_v.float(), p.float())  # (B, H, c, Lp)
        bd = bd_all.reshape(B, H, -1)[:, :, flat].reshape(B, H, c, Lk)
        bd = bd.masked_fill(zero, 0.0)
        return self.apply_attention((ac + bd) * Dk ** -0.5, v, mask, False)


def rel_chunk_align(index: int, c: int, Lk: int, Lp: int, device=None):
    """The rel-pos chunk step's alignment of the (c, Lp) products to the
    (c, Lk) scores, by global positions t (query) and j (key):
    bd[t, j] = q_v[t] . p[Lp-1+j-t] for j <= t, 0 at j == t+1, and
    q_v[t+1] . p[j-t-2] for j > t+1 (the next query's row, inside the chunk
    wherever the chunk policy admits such keys). Returns the flat gather
    index (c Lk,) into the (c Lp) products and the (1, 1, c, Lk) j == t+1
    mask."""
    t_loc = torch.arange(c, device=device)[:, None]
    t_g = index + t_loc
    j = torch.arange(Lk, device=device)[None, :]
    past = j <= t_g
    row = torch.where(past, t_loc, torch.clamp(t_loc + 1, max=c - 1))
    col = torch.clamp(torch.where(past, Lp - 1 + j - t_g, j - t_g - 2), 0, Lp - 1)
    return (row * Lp + col).reshape(-1), (j == t_g + 1)[None, None]
