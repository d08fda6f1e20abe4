"""Fused rel-pos attention, forward and backward: the CUDA port of the Pallas
kernels in ``liteasr_tpu/ops/flash_attention.py``.

K1 / K1' (``flash_attention``, CUDA source ``csrc/rel_attention_fwd.cu``)
replace ``_attn_kernel``. For each folded (batch x head) row ``bh`` it
computes

    S = (Q K^T + relshift(Q_v P^T)) * scale
    S[mask] = S[key >= kv_len] = S[key // chunk > query // chunk] = NEG_INF
    out = dropout(softmax(S)) V          (+ lse = logsumexp(S) per row)

where ``relshift`` is the legacy Transformer-XL alignment of
``liteasr_tpu/nets/attention.py:191-202`` read from the compact (Tk, D)
position table: for key j <= t it reads R[t, Tk-1-t+j], at j == t+1 it
gives 0, and for j > t+1 it reads R[t+1, j-t-2] (the next query's row).
The training options (K1') add the per-row lse and attention-probability
dropout with the TPU kernel's counter hash (``_dropout_keep`` :149), so the
keep mask is the same bit for bit; the normalizer sums the undropped mass
and ``out /= 1 - rate``.

K2 (``flash_rel_attention_bwd``, CUDA source ``csrc/rel_attention_bwd.cu``)
replaces ``_bwd_kernel``: A = exp(S - lse) (0 for masked keys and dead
rows), dV = A_v^T dO, dS = A (dP_eff - rowsum(dO O)) scale, dK = dS^T Q_u,
dQ_u = dS K, dR = relshift^-1(dS), dQ_v = dR P, dP = dR^T Q_v summed over
the batch. K3 (``flash_rel_attention_train``) is the custom VJP joining
them (``flash_rel_attention_train`` :469), a ``torch.autograd.Function``.

The chunk width ``chunk`` (0 = none) is the streaming encoders' chunk
policy, ``triangle_mask(stage=chunk)`` (liteasr_tpu/nets/encoder.py:144-167)
computed from the indices, so no (T, T) mask is materialized: key j is
masked for query t iff j // chunk > t // chunk. The kernels skip the key
tiles (K1, K1', K2's fp32 body) or query tiles (K2's bf16 body) that the
chunk hides from a whole tile, exactly.

On the card each kernel works on 64 x 64 tiles so the (Tq, Tk) score matrix
never reaches device memory, which is what the TPU kernels were written
for. The bf16 bodies, the main path, compute every product on the tensor
cores (``wgmma``) from tiles that ``cp.async`` copies into shared memory;
the fp32 bodies, which serve the parity checks, use scalar fp32 FMAs (the
tensor cores would mean TF32).

Under tensor and sequence parallelism each call is a shard of the full
call (``shard``, a :class:`Shard`): its folded rows may be a slice of each
batch row's heads (``head0`` of ``h_total``, ``h_local`` a batch row), so
the dropout hash folds the full call's row ``b h_total + head0 + h``, and
its queries a contiguous block at ``q0`` of the full call's ``t_q`` over
all the keys, so the rel-pos index ``Tk - 1 - t + j``, the chunk mask and
the hash's tiles (``hash_tiles(t_q, Tk)``) read the full call's query
index. The legacy crossover reads q_v row t + 1 for keys past t + 1, so a
query block that is not the last carries one q_v row more, the next block's
first; K2 returns that row's gradient as the last row of dQ_v, for the
caller to hand back to its owner. Row for row a shard gives what the full
call gives, and its keep mask is the full call's slice, bit for bit. The
default (no shard) is the whole call.

Beside each kernel is its plain PyTorch version (``flash_attention_plain``,
``flash_rel_attention_bwd_plain``, ``dropout_keep_plain``). The wrappers
take them only for CPU tensors; a CUDA tensor launches the kernel or
raises.

K1 (no lse, no dropout) is also the custom op ``liteasr::rel_attention_fwd``
(:data:`rel_attention_fwd`), which :func:`flash_attention` calls for it when
it is traced: its implementation launches the kernel on the card and runs
the plain version on the CPU, and its fake implementation gives the
output's shape, so that ``torch.export`` keeps one node for each K1 call
(``export.py``). The shard is the op's trailing integers. Registering the
op builds nothing; the kernel is built at its first CUDA call. A program
exported with the op needs this module imported to load.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from liteasr_tpu_torch.ops.cuda_libs import Library, check, launch, ptr

NEG_INF = -1e30
MAX_HEAD_DIM = 128
# the TPU kernel's default tiles (liteasr_tpu/ops/flash_attention.py:34-35):
# the dropout hash is keyed by (tile, row and column inside the tile)
HASH_TQ = 128
HASH_TK = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Shard(NamedTuple):
    """Where a call lies in the full attention (see the module docstring):
    local query t is the full call's ``q0 + t`` of ``t_q`` (0: the call's
    own Tq), local folded row ``bh`` is head ``head0 + bh % h_local`` of
    ``h_total`` of batch row ``bh // h_local``."""

    q0: int = 0
    t_q: int = 0
    head0: int = 0
    h_local: int = 1
    h_total: int = 1

    def hash_rows(self, bh: torch.Tensor) -> torch.Tensor:
        """The full call's folded rows of local rows ``bh`` (int64)."""
        return (bh // self.h_local) * self.h_total + self.head0 + bh % self.h_local


WHOLE = Shard()
_MASK32 = 0xFFFFFFFF


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift on (..., T1, T2): pad a zero column,
    reshape to (T2+1, T1), drop the first row, reshape back
    (liteasr_tpu/nets/attention.py:191-202)."""
    *lead, t1, t2 = x.shape
    x_padded = torch.cat([x.new_zeros(*lead, t1, 1), x], dim=-1)
    x_padded = x_padded.reshape(*lead, t2 + 1, t1)
    return x_padded[..., 1:, :].reshape(*lead, t1, t2)


def rel_shift_adjoint(d: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`rel_shift`: the same reshapes in reverse, with the
    dropped row and the padded column as the zero and the cut. dR[t, Tk-1-t+j]
    gets dS[t, j] for j <= t and dR[t+1, j-t-2] gets it for j > t+1
    (``_dbd_to_dR``, liteasr_tpu/ops/flash_attention.py:123-146)."""
    *lead, t1, t2 = d.shape
    d = d.reshape(*lead, t2, t1)
    d = torch.cat([d.new_zeros(*lead, 1, t1), d], dim=-2)
    return d.reshape(*lead, t1, t2 + 1)[..., 1:]


def _group_rows(bh: int, n: int, what: str) -> int:
    if n <= 0 or bh % n:
        raise ValueError(f"{what} has {n} rows, which do not divide BH={bh}")
    return bh // n


def hash_tiles(tq: int, tk: int):
    """The TPU kernel's (tq_eff, tk_eff) for these lengths
    (liteasr_tpu/ops/flash_attention.py:318-319)."""
    return min(HASH_TQ, -(-tq // 8) * 8), min(HASH_TK, -(-tk // 128) * 128)


def keep_threshold(rate: float) -> int:
    """uint32 threshold of the keep test ``u < thr``, clamped (not wrapped)
    at 2**32 - 1 (liteasr_tpu/ops/flash_attention.py:169-173)."""
    if rate <= 0.0:
        return _MASK32
    return min(int(round((1.0 - rate) * 4294967296.0)), _MASK32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32): the product is split
    at 16 bits so that no intermediate leaves int64's positive range."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _murmur_keep(rows, cols, tile, rate):
    u = (_mul32(rows, 0x9E3779B1) + _mul32(cols, 0x85EBCA77)
         + _mul32(tile, 0xC2B2AE3D)) & _MASK32
    u = u ^ (u >> 16)
    u = _mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = _mul32(u, 0x846CA68B)
    u = u ^ (u >> 16)
    return u < keep_threshold(rate)


def _tile_id(b, qi, kj, seed: int):
    tile = (_mul32(b, 65537) + qi) & _MASK32
    tile = (_mul32(tile, 8191) + kj) & _MASK32
    return (_mul32(tile, 131071) + (int(seed) & _MASK32)) & _MASK32


def dropout_keep_plain(tq: int, tk: int, b: int, qi: int, kj: int, seed: int,
                       rate: float) -> torch.Tensor:
    """Torch port of ``_dropout_keep`` (liteasr_tpu/ops/flash_attention.py
    :149-174): the (tq, tk) keep mask of one (batch-head, q-tile, k-tile),
    a murmur3 finalizer over uint32 row/column/tile ids, kept in int64 and
    masked to 32 bits after every multiply and add."""
    rows = torch.arange(tq, dtype=torch.int64)[:, None].expand(tq, tk)
    cols = torch.arange(tk, dtype=torch.int64)[None, :].expand(tq, tk)
    tile = _tile_id(torch.tensor(b, dtype=torch.int64),
                    torch.tensor(qi, dtype=torch.int64),
                    torch.tensor(kj, dtype=torch.int64), seed)
    return _murmur_keep(rows, cols, tile, rate)


def dropout_keep_global(bh: int, t_q: int, t_k: int, seed: int, rate: float,
                        device=None, shard: Shard = WHOLE) -> torch.Tensor:
    """(BH, Tq, Tk) keep mask of the call, with the TPU kernel's tile
    coordinates: query t is row t % tq_eff of q-tile t // tq_eff, key j is
    column j % tk_eff of k-tile j // tk_eff, and ``b`` is the folded row;
    t and b are the full call's (``shard``), the tiles its
    ``hash_tiles(t_q, Tk)``."""
    tqe, tke = hash_tiles(shard.t_q or t_q, t_k)
    t = shard.q0 + torch.arange(t_q, dtype=torch.int64, device=device)[None, :, None]
    j = torch.arange(t_k, dtype=torch.int64, device=device)[None, None, :]
    b = shard.hash_rows(torch.arange(bh, dtype=torch.int64, device=device))[:, None, None]
    tile = _tile_id(b, t // tqe, j // tke, seed)
    return _murmur_keep(t % tqe, j % tke, tile, rate)


def dropout_seed_at_row(seed: int, row0: int) -> int:
    """The int32 seed whose keep masks at folded rows ``bh`` are ``seed``'s
    at rows ``row0 + bh``. The tile id is linear in the row modulo 2**32
    (``_tile_id``: ((b 65537 + qi) 8191 + kj) 131071 + seed), so moving the
    row by ``row0`` moves the seed by ``row0`` 65537 8191 131071. A rank
    holding rows ``row0..`` of the global batch draws the masks those rows
    have in a one-process run."""
    u = (int(seed) + int(row0) * (65537 * 8191 * 131071)) & _MASK32
    return u - (1 << 32) if u >= 1 << 31 else u


def chunk_mask(tq: int, tk: int, chunk: int, device=None, q0: int = 0) -> torch.Tensor:
    """(Tq, Tk) bool, True where key j is hidden from query t (the full
    call's ``q0 + t``) under the chunk width: j // chunk > t // chunk
    (``triangle_mask(stage=chunk)``)."""
    t = q0 + torch.arange(tq, device=device)[:, None]
    j = torch.arange(tk, device=device)[None, :]
    return (j // chunk) > (t // chunk)


def _whole(tq: int, tqv: int, tk: int, shard: Shard) -> bool:
    return shard.q0 == 0 and tq == tqv == tk


def _rel_index(tq: int, tk: int, q0: int, device=None):
    """The legacy ``rel_shift`` of a query block at ``q0`` as a gather:
    score (t, j), with the full call's index tg = q0 + t, reads the
    (Tq + 1, Tk) products q_v . p^T at row t, column Tk - 1 - tg + j for
    j <= tg, and at row t + 1, column j - tg - 2 for j > tg + 1 (the next
    query's row); j == tg + 1 reads nothing. Returns the (Tq Tk,) flat index
    into the products (row stride Tk) and the (Tq, Tk) mask of the scores
    that read one."""
    t = torch.arange(tq, device=device)[:, None]
    tg = q0 + t
    j = torch.arange(tk, device=device)[None, :]
    past = j <= tg
    row = torch.where(past, t, t + 1)
    col = torch.clamp(torch.where(past, tk - 1 - tg + j, j - tg - 2), 0, tk - 1)
    return (row * tk + col).reshape(-1), j != tg + 1


def _rel_scores(rel_qv, p, tq: int, q0: int):
    """(BH, Tq, Tk) rel-pos term of a query block at ``q0``; ``rel_qv`` has
    Tq rows, or Tq + 1 with the next block's first."""
    bh, tqv = rel_qv.shape[:2]
    prod = torch.einsum("bqd,bkd->bqk", rel_qv, p)
    tk = prod.shape[-1]
    if tqv == tq:  # the last block: no row reads past it
        prod = torch.cat([prod, prod.new_zeros(bh, 1, tk)], dim=1)
    idx, live = _rel_index(tq, tk, q0, prod.device)
    bd = prod.reshape(bh, -1)[:, idx].reshape(bh, tq, tk)
    return torch.where(live, bd, 0.0)


def _rel_scores_adjoint(ds, tqv: int, q0: int):
    """Adjoint of :func:`_rel_scores`: the (BH, Tqv, Tk) gradient of the
    products from the scores' ``ds``."""
    bh, tq, tk = ds.shape
    idx, live = _rel_index(tq, tk, q0, ds.device)
    dr = ds.new_zeros(bh, (tq + 1) * tk)
    dr.index_add_(1, idx, torch.where(live, ds, 0.0).reshape(bh, -1))
    return dr.reshape(bh, tq + 1, tk)[:, :tqv]


def _check_shard(tq: int, tqv: int, tk: int, shard: Shard, what: str):
    """A rel-pos query block lies inside the keys, and carries the next
    block's first q_v row unless it is the last block (which may carry a
    row that nothing reads)."""
    if shard.q0 < 0 or shard.q0 + tq > tk:
        raise ValueError(f"{what}: queries {shard.q0}..{shard.q0 + tq} lie outside "
                         f"the {tk} keys")
    if tqv not in (tq + (shard.q0 + tq < tk), tq + 1):
        raise ValueError(f"{what}: a block of {tq} queries at {shard.q0} of {tk} "
                         f"takes {tq + (shard.q0 + tq < tk)} q_v rows, got {tqv}")


def _scores_plain(q, k, mask, kv_lens, rel_qv, rel_p, scale, chunk=0,
                  shard: Shard = WHOLE):
    """fp32 (BH, Tq, Tk) masked scores."""
    bh, tq = q.shape[:2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    if rel_qv is not None:
        p = rel_p.float()
        p = p.repeat(_group_rows(bh, p.shape[0], "rel_p"), 1, 1)
        if _whole(tq, rel_qv.shape[1], k.shape[1], shard):
            s = s + rel_shift(torch.einsum("bqd,bkd->bqk", rel_qv.float(), p))
        else:
            _check_shard(tq, rel_qv.shape[1], k.shape[1], shard, "flash_attention")
            s = s + _rel_scores(rel_qv.float(), p, tq, shard.q0)
    s = s * scale
    if mask is not None:
        m = mask.repeat_interleave(_group_rows(bh, mask.shape[0], "mask"), 0)
        s = s.masked_fill(m, NEG_INF)
    if kv_lens is not None:
        j = torch.arange(s.shape[-1], device=s.device)
        s = s.masked_fill(j[None, None, :] >= kv_lens[:, None, None], NEG_INF)
    if chunk > 0:
        s = s.masked_fill(chunk_mask(s.shape[1], s.shape[2], chunk, s.device,
                                     shard.q0)[None], NEG_INF)
    return s


def flash_attention_plain(q, k, v, mask=None, kv_lens=None, rel_qv=None,
                          rel_p=None, scale: float = 1.0,
                          return_lse: bool = False, dropout_rate: float = 0.0,
                          dropout_seed: int = 0, chunk: int = 0,
                          shard: Shard = WHOLE):
    """Plain PyTorch version of the kernel: fp32 scores and softmax.

    Same arguments as :func:`flash_attention`; follows
    ``_ref_rel_attention`` (liteasr_tpu/ops/flash_attention.py:450-466)
    plus the mask input, the per-row lse and the dropout of ``_attn_kernel``.
    """
    s = _scores_plain(q, k, mask, kv_lens, rel_qv, rel_p, scale, chunk, shard)
    attn = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = dropout_keep_global(q.shape[0], q.shape[1], k.shape[1],
                                   dropout_seed, dropout_rate, q.device, shard)
        attn = torch.where(keep, attn, 0.0)
    out = torch.einsum("bqk,bkd->bqd", attn, v.float())
    if dropout_rate > 0.0:
        out = out / (1.0 - dropout_rate)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    return out, torch.where(lse <= NEG_INF / 2, NEG_INF, lse)


def _k1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
        kv_lens: Optional[torch.Tensor], rel_qv: Optional[torch.Tensor],
        rel_p: Optional[torch.Tensor], scale: float, chunk: int, q0: int, t_q: int,
        head0: int, h_local: int, h_total: int) -> torch.Tensor:
    """K1 (:func:`flash_attention`'s arguments without the lse and the
    dropout, the shard as its fields): on the card the kernel
    (``csrc/rel_attention_fwd.cu``), counted; on the CPU the plain version."""
    shard = Shard(q0, t_q, head0, h_local, h_total)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, kv_lens, rel_qv, rel_p, scale,
                                     chunk=chunk, shard=shard)
    out, _ = _launch_fwd(q, k, v, mask, kv_lens, rel_qv, rel_p, scale, False, 0.0, 0, chunk,
                         shard)
    flash_attention.launches += 1
    flash_attention.chunk_launches += chunk > 0
    return out


# K1 as the op liteasr::rel_attention_fwd, for the programs that trace it
rel_attention_fwd = torch.library.custom_op("liteasr::rel_attention_fwd", _k1, mutates_args=())


@rel_attention_fwd.register_fake
def _rel_attention_fwd_fake(q, k, v, mask, kv_lens, rel_qv, rel_p, scale, chunk, q0, t_q,
                            head0, h_local, h_total):
    return torch.empty_like(q)


def flash_attention(q, k, v, mask=None, kv_lens=None, rel_qv=None,
                    rel_p=None, scale: float = 1.0, return_lse: bool = False,
                    dropout_rate: float = 0.0, dropout_seed: int = 0,
                    chunk: int = 0, shard: Shard = WHOLE):
    """Fused attention forward (K1; K1' with ``return_lse``/dropout).

    :param q: (BH, Tq, D); ``k``/``v``: (BH, Tk, D); float32 or bfloat16
    :param mask: optional (M, Tq, Tk) bool, True = masked; row ``bh`` reads
        ``mask[bh // (BH // M)]`` (M = B shares one mask across the heads
        of a batch row)
    :param kv_lens: optional (BH,) int32; keys at position >= kv_len are
        masked (suffix padding)
    :param rel_qv: optional (BH, Tq, D) position-query rows (q + pos_bias_v);
        under a ``shard`` whose queries end before the keys, (BH, Tq + 1, D)
        with the next block's first row
    :param rel_p: (P, Tk, D) compact position table; row ``bh`` reads
        ``rel_p[bh % P]`` (P = H shares it across the batch). Needs
        Tq == Tk, or a ``shard`` whose queries lie inside the keys.
    :param return_lse: also return the (BH, Tq) fp32 per-row logsumexp of
        the masked scores, NEG_INF for a row with no key
    :param dropout_rate: attention-probability dropout with the TPU
        kernel's counter hash, keyed by ``dropout_seed`` (an int32)
    :param chunk: chunk width, 0 = none; key j is masked for query t iff
        j // chunk > t // chunk
    :param shard: where the call lies in the full attention (:class:`Shard`)
    :return: (BH, Tq, D) in q's dtype [, lse]

    A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor launches
    the kernel. ``flash_attention.launches`` counts those launches,
    ``flash_attention.lse_launches`` the ones with ``return_lse`` (K1'),
    and ``chunk_launches`` / ``lse_chunk_launches`` those of each that ran
    with a chunk width. Traced, K1 is the op :data:`rel_attention_fwd`.
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"flash_attention: dropout_rate {dropout_rate} not in [0, 1)")
    chunk = _chunk_width(chunk)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not return_lse and dropout_rate == 0.0:
        # a traced program (torch.export, torch.compile) keeps K1 as one op
        # node; an eager call skips the dispatcher's host cost per call
        k1 = torch.ops.liteasr.rel_attention_fwd if torch.compiler.is_compiling() else _k1
        return k1(q, k, v, mask, kv_lens, rel_qv, rel_p, float(scale), chunk, *shard)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, kv_lens, rel_qv, rel_p,
                                     scale, return_lse, dropout_rate,
                                     dropout_seed, chunk, shard)
    out, lse = _launch_fwd(q, k, v, mask, kv_lens, rel_qv, rel_p, scale,
                           return_lse, dropout_rate, dropout_seed, chunk, shard)
    flash_attention.launches += 1
    flash_attention.chunk_launches += chunk > 0
    if return_lse:
        flash_attention.lse_launches += 1
        flash_attention.lse_chunk_launches += chunk > 0
        return out, lse
    return out


flash_attention.launches = 0
flash_attention.lse_launches = 0
flash_attention.chunk_launches = 0
flash_attention.lse_chunk_launches = 0


def flash_rel_attention_bwd_plain(q_u, qv, k, v, p, kv_lens, out, lse, dout,
                                  scale: float, dropout_rate: float = 0.0,
                                  dropout_seed: int = 0, chunk: int = 0,
                                  shard: Shard = WHOLE):
    """Plain PyTorch version of K2: the closed form of ``_bwd_kernel``
    (liteasr_tpu/ops/flash_attention.py:566-680) on the full (Tq, Tk) score
    matrix. Inputs as :func:`flash_rel_attention_bwd`; returns fp32
    (dq_u, dqv, dk, dv, dp)."""
    bh = q_u.shape[0]
    s = _scores_plain(q_u, k, None, kv_lens, qv, p, scale, chunk, shard)
    lse = lse.float()[:, :, None]
    dead = lse <= NEG_INF / 2
    a = torch.where(dead | (s <= NEG_INF / 2), 0.0,
                    torch.exp(s - torch.where(dead, 0.0, lse)))
    dout = dout.float()
    vf = v.float()
    dp_ = torch.einsum("bqd,bkd->bqk", dout, vf)
    if dropout_rate > 0.0:
        keep = dropout_keep_global(bh, q_u.shape[1], k.shape[1], dropout_seed,
                                   dropout_rate, q_u.device, shard)
        inv_keep = 1.0 / (1.0 - dropout_rate)
        a_v = torch.where(keep, a, 0.0) * inv_keep
        dp_ = torch.where(keep, dp_, 0.0) * inv_keep
    else:
        a_v = a
    dvec = (dout * out.float()).sum(-1, keepdim=True)
    ds = a * (dp_ - dvec) * scale
    dv = torch.einsum("bqk,bqd->bkd", a_v, dout)
    dk = torch.einsum("bqk,bqd->bkd", ds, q_u.float())
    dq_u = torch.einsum("bqk,bkd->bqd", ds, k.float())
    if _whole(q_u.shape[1], qv.shape[1], k.shape[1], shard):
        dr = rel_shift_adjoint(ds)
    else:
        dr = _rel_scores_adjoint(ds, qv.shape[1], shard.q0)
    p_rows = p.shape[0]
    p_rep = p.float().repeat(_group_rows(bh, p_rows, "p"), 1, 1)
    dqv = torch.einsum("bqk,bkd->bqd", dr, p_rep)
    dp = torch.einsum("bqk,bqd->bkd", dr, qv.float())
    dp = dp.reshape(bh // p_rows, p_rows, *dp.shape[1:]).sum(0)
    return dq_u, dqv, dk, dv, dp


def flash_rel_attention_bwd(q_u, qv, k, v, p, kv_lens, out, lse, dout,
                            scale: float, dropout_rate: float = 0.0,
                            dropout_seed: int = 0, chunk: int = 0,
                            shard: Shard = WHOLE):
    """K2: gradients of the rel-pos attention forward.

    :param q_u: (BH, Tq, D); ``qv``: (BH, Tq or Tq + 1, D) as the forward
        took it; ``k``/``v``: (BH, Tk, D); ``p``: (P, Tk, D) shared as in
        :func:`flash_attention`; all float32 or bfloat16. Tq == Tk without
        a ``shard``.
    :param kv_lens: (BH,) int32 or None
    :param out: the forward's output as returned, in fp32 (BH, Tq, D)
    :param lse: the forward's (BH, Tq) fp32 lse
    :param dout: (BH, Tq, D) fp32 cotangent of ``out``
    :param chunk: the forward's chunk width (0 = none)
    :param shard: the forward's :class:`Shard`
    :return: fp32 (dq_u, dqv, dk, dv, dp), dqv shaped as ``qv`` (its row Tq,
        if any, is the gradient of the next block's first q_v row), dp summed
        over the batch rows

    A CPU tensor takes :func:`flash_rel_attention_bwd_plain`; a CUDA tensor
    launches the kernel (``flash_rel_attention_bwd.launches`` counts them,
    ``chunk_launches`` those with a chunk width).
    """
    chunk = _chunk_width(chunk)
    if q_u.device.type == "cpu":
        return flash_rel_attention_bwd_plain(
            q_u, qv, k, v, p, kv_lens, out, lse, dout, scale, dropout_rate,
            dropout_seed, chunk, shard)
    if q_u.device.type != "cuda":
        raise ValueError(f"flash_rel_attention_bwd: unsupported device {q_u.device}")
    grads = _launch_bwd(q_u, qv, k, v, p, kv_lens, out, lse, dout, scale,
                        dropout_rate, dropout_seed, chunk, shard)
    flash_rel_attention_bwd.launches += 1
    flash_rel_attention_bwd.chunk_launches += chunk > 0
    return grads


flash_rel_attention_bwd.launches = 0
flash_rel_attention_bwd.chunk_launches = 0


class FlashRelAttentionTrain(torch.autograd.Function):
    """K3: differentiable fused rel-pos attention (the custom VJP
    ``flash_rel_attention_train``, liteasr_tpu/ops/flash_attention.py
    :469-522). Forward = K1' with lse and dropout, returned in fp32;
    backward = K2 with the regenerated keep mask, grads in the inputs'
    dtypes. Both under the same chunk width and shard."""

    @staticmethod
    def forward(ctx, q_u, qv, k, v, p, kv_lens, seed: int, scale: float,
                dropout_rate: float, chunk: int, shard: Shard):
        out, lse = flash_attention(
            q_u, k, v, kv_lens=kv_lens, rel_qv=qv, rel_p=p, scale=scale,
            return_lse=True, dropout_rate=dropout_rate, dropout_seed=seed,
            chunk=chunk, shard=shard)
        out = out.float()
        ctx.save_for_backward(q_u, qv, k, v, p, kv_lens, out, lse)
        ctx.seed, ctx.scale, ctx.rate, ctx.chunk = seed, scale, dropout_rate, chunk
        ctx.shard = shard
        return out

    @staticmethod
    def backward(ctx, dout):
        q_u, qv, k, v, p, kv_lens, out, lse = ctx.saved_tensors
        grads = flash_rel_attention_bwd(
            q_u, qv, k, v, p, kv_lens, out, lse, dout.float().contiguous(),
            ctx.scale, ctx.rate, ctx.seed, ctx.chunk, ctx.shard)
        cast = [g.to(x.dtype) for g, x in zip(grads, (q_u, qv, k, v, p))]
        return (*cast, None, None, None, None, None, None)


def flash_rel_attention_train(q_u, qv, k, v, p, kv_lens, seed: int,
                              scale: float, dropout_rate: float = 0.0,
                              chunk: int = 0, shard: Shard = WHOLE):
    """Differentiable fused rel-pos attention (conformer self-attention in
    train mode). ``q_u``/``qv``/``k``/``v`` (BH, T, D), ``p`` (P, T, D),
    ``kv_lens`` (BH,) int32 or None, ``seed`` an int32 for the dropout hash,
    ``chunk`` the chunk width (0 = none), ``shard`` where the call lies in
    the full attention (``q_u`` (BH, Tq, D), ``qv`` (BH, Tq [+ 1], D) then).
    Returns fp32 (BH, Tq, D)."""
    return FlashRelAttentionTrain.apply(q_u, qv, k, v, p, kv_lens, int(seed),
                                        float(scale), float(dropout_rate),
                                        _chunk_width(chunk), Shard(*shard))


def _chunk_width(chunk) -> int:
    chunk = int(chunk)
    if chunk < 0:
        raise ValueError(f"flash_attention: chunk width {chunk} < 0")
    return chunk


def _dropout_args(dropout_rate: float, seed: int):
    """(enabled, seed as uint32, threshold) for the kernels' hash."""
    on = dropout_rate > 0.0
    return (int(on), ctypes.c_uint32(int(seed) & _MASK32),
            ctypes.c_uint32(keep_threshold(dropout_rate)))


def _shard_args(tqv: int, shard: Shard):
    """The kernels' trailing (tqv, qoff, hl, ht, h0)."""
    if not (shard.h_local >= 1 and shard.head0 >= 0
            and shard.head0 + shard.h_local <= shard.h_total):
        raise ValueError(f"flash_attention: heads {shard.head0}.."
                         f"{shard.head0 + shard.h_local} of {shard.h_total}")
    return (tqv, shard.q0, shard.h_local, shard.h_total, shard.head0)


# K1/K1' and K2's C entry points (csrc/rel_attention_fwd.cu, csrc/rel_attention_bwd.cu)
_FWD = Library("rel_attention_fwd", rel_attention_fwd=(
    [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]))
_BWD = Library("rel_attention_bwd", rel_attention_bwd=(
    [ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]))


def _launch_fwd(q, k, v, mask, kv_lens, rel_qv, rel_p, scale, return_lse,
                dropout_rate, dropout_seed, chunk, shard):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"flash_attention: q must be (BH, Tq, D), got {tuple(q.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_HEAD_DIM}")
    dev = q.device
    check("flash_attention", dev, ("q", q, q.dtype, (bh, tq, d)),
          ("k", k, q.dtype, (bh, tk, d)), ("v", v, q.dtype, (bh, tk, d)))
    mask_div, p_mod = 1, 1
    if mask is not None:
        mask_div = _group_rows(bh, mask.shape[0], "mask")
        check("flash_attention", dev, ("mask", mask, torch.bool, (bh // mask_div, tq, tk)))
        mask = mask.view(torch.uint8)
    if kv_lens is not None:
        check("flash_attention", dev, ("kv_lens", kv_lens, torch.int32, (bh,)))
    if (rel_qv is None) != (rel_p is None):
        raise ValueError("flash_attention: rel_qv and rel_p go together")
    tqv = tq
    if rel_qv is not None:
        tqv = rel_qv.shape[1]
        _check_shard(tq, tqv, tk, shard, "flash_attention")
        p_mod = rel_p.shape[0]
        _group_rows(bh, p_mod, "rel_p")
        check("flash_attention", dev, ("rel_qv", rel_qv, q.dtype, (bh, tqv, d)),
              ("rel_p", rel_p, q.dtype, (p_mod, tk, d)))
    elif shard.q0 + tq > (shard.t_q or tq):
        raise ValueError(f"flash_attention: queries {shard.q0}..{shard.q0 + tq} "
                         f"past the full call's {shard.t_q}")
    out = torch.empty_like(q)
    lse = (torch.empty((bh, tq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if bh == 0 or tq == 0:
        return out, lse
    on, seed, thr = _dropout_args(dropout_rate, dropout_seed)
    tqe, tke = hash_tiles(shard.t_q or tq, tk)
    launch(_FWD.load().rel_attention_fwd, dev,
           _DTYPE_CODE[q.dtype], ptr(q), ptr(k), ptr(v), ptr(rel_qv), ptr(rel_p), ptr(mask),
           ptr(kv_lens), ptr(out), ptr(lse), bh, tq, tk, d, mask_div, p_mod,
           ctypes.c_float(scale), on, seed, thr, ctypes.c_float(1.0 - dropout_rate), tqe,
           tke, chunk, *_shard_args(tqv, shard))
    return out, lse


def _launch_bwd(q_u, qv, k, v, p, kv_lens, out, lse, dout, scale,
                dropout_rate, dropout_seed, chunk, shard):
    if q_u.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_rel_attention_bwd: unsupported dtype {q_u.dtype}")
    if q_u.dim() != 3:
        raise ValueError(f"flash_rel_attention_bwd: q_u must be (BH, T, D), "
                         f"got {tuple(q_u.shape)}")
    bh, t, d = q_u.shape
    tk, tqv = k.shape[1], qv.shape[1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_rel_attention_bwd: head dim {d} not in 1..{MAX_HEAD_DIM}")
    dev, dt = q_u.device, q_u.dtype
    p_mod = p.shape[0]
    _group_rows(bh, p_mod, "p")
    _check_shard(t, tqv, tk, shard, "flash_rel_attention_bwd")
    check("flash_rel_attention_bwd", dev, ("q_u", q_u, dt, (bh, t, d)),
          ("qv", qv, dt, (bh, tqv, d)), ("k", k, dt, (bh, tk, d)), ("v", v, dt, (bh, tk, d)),
          ("p", p, dt, (p_mod, tk, d)), ("out", out, torch.float32, (bh, t, d)),
          ("dout", dout, torch.float32, (bh, t, d)), ("lse", lse, torch.float32, (bh, t)))
    if kv_lens is not None:
        check("flash_rel_attention_bwd", dev, ("kv_lens", kv_lens, torch.int32, (bh,)))
    # the fp32 body owns dQ_u per query tile and sums dK, dV, dQ_v and dP
    # with atomics; the bf16 body owns dK, dV per key tile and sums dQ_u,
    # dQ_v and dP. dP is the shared table's gradient, summed over the rows
    # bh that share it, in both.
    tc = dt == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=dev)
    dq_u = (torch.zeros if tc else torch.empty)((bh, t, d), **f32)
    dk, dv = ((torch.empty if tc else torch.zeros)((bh, tk, d), **f32)
              for _ in range(2))
    dqv = torch.zeros((bh, tqv, d), **f32)
    dp = torch.zeros((p_mod, tk, d), **f32)
    # bf16 scratch: dO in bf16 and Dvec = rowsum(dO * O), from a pre-pass
    dob = torch.empty((bh, t, d), dtype=torch.bfloat16, device=dev) if tc else None
    dvec = torch.empty((bh, t), dtype=torch.float32, device=dev) if tc else None
    if bh and t:
        on, seed, thr = _dropout_args(dropout_rate, dropout_seed)
        tqe, tke = hash_tiles(shard.t_q or t, tk)
        inv_keep = 1.0 / (1.0 - dropout_rate) if on else 1.0
        launch(_BWD.load().rel_attention_bwd, dev,
               _DTYPE_CODE[dt], ptr(q_u), ptr(qv), ptr(k), ptr(v), ptr(p), ptr(kv_lens),
               ptr(out), ptr(lse), ptr(dout), ptr(dq_u), ptr(dqv), ptr(dk), ptr(dv), ptr(dp),
               ptr(dob), ptr(dvec), bh, t, tk, d, p_mod, ctypes.c_float(scale), on, seed, thr,
               ctypes.c_float(inv_keep), tqe, tke, chunk, *_shard_args(tqv, shard))
    return dq_u, dqv, dk, dv, dp
