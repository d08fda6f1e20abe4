"""Tensor and sequence parallelism: the Megatron rules over the tp group,
the time split over the sp group, and the autograd collectives that join
the shards (liteasr_tpu/parallel/sharding.py, liteasr_tpu/parallel/mesh.py
:71-80).

**Rules** (:data:`TP_RULES`, the port's copy of the JAX package's
``_TP_RULES``; the first match of a module path wins): the FFNs' ``fc1``,
the attentions' ``linear_q/k/v`` and ``linear_pos`` and the conformer conv's
``pointwise_conv1`` are column-parallel (the weight's output rows and the
bias sharded), ``fc2``, ``linear_o`` and ``pointwise_conv2`` row-parallel
(the weight's input columns sharded, the bias replicated), the rel-pos
biases ``pos_bias_u/v`` sharded by heads; everything else (LayerNorms,
embeddings, the output layer, the CTC head, the subsampling, the
transducer's LSTM prediction network and joint, the Paraformer's CIF
predictor, wav2vec 2.0's extractor, quantizer, projections and positional
conv) is replicated. The Paraformer's parallel decoder layers are U2's
decoder layers and wav2vec 2.0's encoder layers U2's transformer layers,
and they follow the same rules.
The port's weight is (out, in), the transpose of flax's kernel, so a
column rule shards dim 0 where JAX's ``P(None, 'tp')`` shards the kernel's
dim 1.

One difference from JAX, by design: the GLU pairs. JAX shards
``pointwise_conv1``'s 2d outputs contiguously and lets GSPMD reshard before
the GLU, replicating the depthwise conv and the BatchNorm. Here tp rank r
holds both halves of its pairs, output rows [r d/tp, (r+1) d/tp) and
[d + r d/tp, d + (r+1) d/tp), so that the GLU, the depthwise conv, the
BatchNorm and the activation run on the rank's d/tp channels
(:data:`CHANNEL_RULES`) and ``pointwise_conv2`` is row-parallel: the same
function with one all-reduce per conv module.

**Collectives.** Megatron's :func:`copy_to_tp` (identity forward, all-reduce
backward) in front of every column-parallel block and :func:`reduce_from_tp`
(all-reduce forward, identity backward) behind every row-parallel one; for
sp, :func:`gather_from_sp` (every rank's frames, the backward's sum over the
group cut to the rank's own) and :func:`sp_halo` (the depthwise conv's
(K - 1) / 2 frames on each side from the neighbours). A gather is an
``all_gather`` of blocks padded to the largest; the backward's
reduce-scatter is an all-reduce followed by a slice. Gloo takes
``all_gather``, ``all_reduce`` and ``broadcast`` on CUDA tensors as NCCL
does; its ``reduce_scatter`` is not relied on.

**Sequence shards.** Time is split in contiguous blocks, the first
``T mod sp`` ranks one frame longer (:func:`split_sizes`).

**State.** :func:`shard_state_dict` cuts a rank's shard from the full
layout, :func:`merge_state_dicts` joins the tp shards back, and
:func:`gather_state_dict` / :func:`gather_flat` do that across the tp
group, so that checkpoints are always in the one-process layout.
"""

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from liteasr_tpu_torch.parallel import mesh

# (module path regex, weight dim, bias dim or None = replicated): the JAX
# package's _TP_RULES (liteasr_tpu/parallel/sharding.py:24-35) on the port's
# (out, in) weights; first match wins
TP_RULES: Tuple[Tuple[str, int, Optional[int]], ...] = (
    (r"(feed_forward|feed_forward_macaron)\.fc1$", 0, 0),
    (r"pointwise_conv1$", 0, 0),
    (r"(self_attn|src_attn)\.linear_[qkv]$", 0, 0),
    (r"(self_attn|src_attn)\.linear_pos$", 0, 0),
    (r"(feed_forward|feed_forward_macaron)\.fc2$", 1, None),
    (r"pointwise_conv2$", 1, None),
    (r"(self_attn|src_attn)\.linear_o$", 1, None),
)
# the port's GLU-pair layout: pointwise_conv1's output rows are (a, b) pairs,
# and the conv module's channels follow the rank's pairs
GLU = r"pointwise_conv1$"
CHANNEL_RULES = (r"conv\.depthwise_conv$", r"conv\.norm$")
HEAD_LEAVES = ("pos_bias_u", "pos_bias_v")
# the model config's widths that tp divides, by family: the heads, the FFN
# widths and the conformer conv module's channels (enc_dim)
TP_WIDTHS = {
    "U2": ("enc_attn_heads", "dec_attn_heads", "enc_ff_dim", "dec_ff_dim", "enc_dim"),
    "Transducer": ("enc_attn_heads", "enc_ff_dim", "enc_dim"),
    "Paraformer": ("enc_attn_heads", "dec_attn_heads", "enc_ff_dim", "dec_ff_dim",
                   "enc_dim"),
    "Wav2Vec2": ("encoder_attention_heads", "encoder_ffn_embed_dim"),
}


def shard_dim(key: str, ndim: int) -> Optional[int]:
    """The dim of state-dict tensor ``key`` (``ndim`` dims) that tp shards,
    None if it is replicated."""
    parent, _, leaf = key.rpartition(".")
    for pattern, wdim, bdim in TP_RULES:
        if re.search(pattern, parent):
            return wdim if leaf == "weight" and ndim == 2 else bdim if leaf == "bias" else None
    if any(re.search(p, parent) for p in CHANNEL_RULES):
        return 0
    if leaf in HEAD_LEAVES and ndim == 2:
        return 0
    return None


def is_glu(key: str) -> bool:
    return bool(re.search(GLU, key.rpartition(".")[0]))


def shard_tensor(full: torch.Tensor, key: str, rank: int, tp: int) -> torch.Tensor:
    """tp rank ``rank``'s shard of the full tensor ``key``."""
    dim = shard_dim(key, full.dim())
    if dim is None or tp == 1:
        return full
    if full.shape[dim] % tp:
        raise ValueError(f"{key}: dim {dim} of {tuple(full.shape)} is not a multiple of tp={tp}")
    if is_glu(key):  # both halves of the rank's pairs
        return torch.cat([h.chunk(tp, dim)[rank] for h in full.chunk(2, dim)], dim)
    return full.chunk(tp, dim)[rank]


def merge_tensor(shards: Sequence[torch.Tensor], key: str) -> torch.Tensor:
    """The full tensor ``key`` from every tp rank's shard, in rank order."""
    dim = shard_dim(key, shards[0].dim())
    if dim is None or len(shards) == 1:
        return shards[0]
    if is_glu(key):
        halves = [s.chunk(2, dim) for s in shards]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim)
    return torch.cat(list(shards), dim)


def shard_state_dict(full: Dict[str, torch.Tensor], rank: int, tp: int) -> Dict[str, torch.Tensor]:
    return {k: shard_tensor(v, k, rank, tp).clone() for k, v in full.items()}


def merge_state_dicts(shards: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: merge_tensor([s[k] for s in shards], k) for k in shards[0]}


def _merge_tp(local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``local``'s tp-sharded leaves joined across the tp group, on the
    CPU: one ``all_gather`` of their concatenation per dtype."""
    sharded = [k for k, v in local.items() if shard_dim(k, v.dim()) is not None]
    out = {k: v.cpu() for k, v in local.items()}
    tp = mesh.layout().tp
    for dtype in dict.fromkeys(local[k].dtype for k in sharded):
        keys = [k for k in sharded if local[k].dtype == dtype]
        flat = torch.cat([local[k].reshape(-1) for k in keys])
        ranks = [torch.empty_like(flat) for _ in range(tp)]
        mesh.tally("state", "tp")
        dist.all_gather(ranks, flat, group=mesh.group("tp"))
        parts = [r.cpu().split([local[k].numel() for k in keys]) for r in ranks]
        for i, k in enumerate(keys):
            out[k] = merge_tensor([p[i].view(local[k].shape) for p in parts], k)
    return out


def gather_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict in the full (one-process) layout, on the CPU;
    a collective over the tp group, which every rank calls."""
    local = {k: v.detach() for k, v in module.state_dict().items()}
    if not getattr(module, "tp_sharded", False):
        return {k: v.cpu() for k, v in local.items()}
    return _merge_tp(local)


def gather_flat(vec: torch.Tensor, named: Sequence[Tuple[str, torch.Tensor]]) -> torch.Tensor:
    """A flat vector over the local parameters ``named`` (the optimizer's
    moments) in the full layout's flat order, on the CPU; a collective over
    the tp group."""
    parts = vec.split([p.numel() for _, p in named])
    local = {key: part.view_as(p) for (key, p), part in zip(named, parts)}
    if mesh.layout().tp > 1:
        local = _merge_tp(local)
    return torch.cat([local[key].reshape(-1).cpu() for key, _ in named])


def shard_flat(full: torch.Tensor, named: Sequence[Tuple[str, torch.Tensor]],
               full_shapes: Dict[str, torch.Size]) -> torch.Tensor:
    """The local parameters' part of a flat vector in the full layout (the
    inverse of :func:`gather_flat`)."""
    lay = mesh.layout()
    parts = full.split([full_shapes[k].numel() for k, _ in named])
    return torch.cat([shard_tensor(part.view(full_shapes[k]), k, lay.tp_i, lay.tp).reshape(-1)
                      for (k, _), part in zip(named, parts)])


# ------------------------------------------------------------- tp autograd

class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        mesh.tally("activation_grad", "tp")
        dist.all_reduce(g, group=mesh.group("tp"))
        return g


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        mesh.tally("activation", "tp")
        dist.all_reduce(y, group=mesh.group("tp"))
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's copy into a column-parallel block: the identity forward,
    the sum of the tp ranks' input gradients backward."""
    return _CopyToTp.apply(x)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's reduction behind a row-parallel block: the sum of the tp
    ranks' partial outputs forward, the identity backward."""
    return _ReduceFromTp.apply(x)


def copy_inputs_to_tp(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """:func:`copy_to_tp` of each distinct input, once (a self-attention's
    query, key and value are one tensor)."""
    done: Dict[int, torch.Tensor] = {}
    for x in xs:
        if id(x) not in done:
            done[id(x)] = copy_to_tp(x)
    return tuple(done[id(x)] for x in xs)


# ------------------------------------------------------------- sp shards

def split_sizes(total: int, parts: int) -> Tuple[int, ...]:
    """Contiguous blocks of ``total``, the first ``total % parts`` one
    longer."""
    return tuple(total // parts + (i < total % parts) for i in range(parts))


class SeqShard(NamedTuple):
    """This rank's block of a time axis of ``sum(sizes)`` frames."""

    sizes: Tuple[int, ...]
    index: int

    @property
    def lo(self) -> int:
        return sum(self.sizes[:self.index])

    @property
    def hi(self) -> int:
        return self.lo + self.sizes[self.index]

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def last(self) -> bool:
        return self.index == len(self.sizes) - 1


def seq_shard(total: int) -> SeqShard:
    """The sp rank's block of ``total`` frames."""
    lay = mesh.layout()
    return SeqShard(split_sizes(total, lay.sp), lay.sp_i)


class _GatherSp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, sizes: Tuple[int, ...]):
        me, dim = mesh.layout().sp_i, dim % x.dim()
        padded = F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, max(sizes) - sizes[me]])
        blocks = [torch.empty_like(padded) for _ in sizes]
        mesh.tally("gather", "sp")
        dist.all_gather(blocks, padded.contiguous(), group=mesh.group("sp"))
        ctx.dim, ctx.lo, ctx.n = dim, sum(sizes[:me]), sizes[me]
        return torch.cat([b.narrow(dim, 0, n) for b, n in zip(blocks, sizes)], dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        mesh.tally("gather_grad", "sp")
        dist.all_reduce(g, group=mesh.group("sp"))
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


def gather_from_sp(x: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """Every sp rank's block of ``x`` along ``dim`` (block i of
    ``sizes[i]``), joined; the backward sums the group's gradients of the
    whole and keeps the rank's block."""
    return _GatherSp.apply(x, dim, tuple(int(s) for s in sizes))


def sp_halo(x: torch.Tensor, pad: int, seq: SeqShard) -> torch.Tensor:
    """(B, T_local + 2 pad, C): the rank's frames with the ``pad`` frames
    before and after them on the full time axis, zeros past its ends (the
    SAME padding of a convolution over the whole). Each rank contributes
    its first and last ``pad`` frames (fewer if it holds fewer), so a halo
    may span several neighbours."""
    n = len(seq.sizes)
    b, t, c = x.shape
    edge = min(pad, t)
    head = torch.cat([x[:, :edge], x.new_zeros(b, pad - edge, c)], 1)
    tail = torch.cat([x.new_zeros(b, pad - edge, c), x[:, t - edge:]], 1)
    edges = gather_from_sp(torch.cat([head, tail], 1), 1, [2 * pad] * n)
    edges = edges.view(b, n, 2, pad, c)
    zeros = x.new_zeros(b, pad, c)
    left = [zeros] + [edges[:, r, 1, pad - min(pad, seq.sizes[r]):] for r in range(seq.index)]
    right = [edges[:, r, 0, :min(pad, seq.sizes[r])] for r in range(seq.index + 1, n)] + [zeros]
    return torch.cat([torch.cat(left, 1)[:, -pad:], x, torch.cat(right, 1)[:, :pad]], 1)


# ------------------------------------------------------------- the model

def check_widths(model_cfg, tp: int, family: str = "U2") -> None:
    """tp must divide the heads and the widths it shards of ``family``'s
    config (:data:`TP_WIDTHS`)."""
    if tp == 1:
        return
    for key in TP_WIDTHS[family]:
        val = model_cfg.get(key)
        if val is not None and int(val) % tp:
            raise ValueError(f"distributed.tp={tp} does not divide model.{key}={val}")


def shard_model(model: torch.nn.Module, lay: "mesh.Layout", model_cfg=None) -> torch.nn.Module:
    """Make the full (one-process) ``model`` this rank's shard, in place:
    under tp its sharded parameters and buffers become the rank's slices
    and the attentions, FFNs and conv modules run Megatron's collectives;
    under sp the encoder runs on the rank's block of frames and the model's
    tail on its block of rows (wav2vec 2.0: its logits on its block of
    frames). Every family of :data:`TP_WIDTHS`; a tp that does not divide
    ``model_cfg``'s heads and widths raises."""
    from liteasr_tpu_torch.nets.attention import MultiHeadAttention
    from liteasr_tpu_torch.nets.common import PositionwiseFeedForward
    from liteasr_tpu_torch.nets.layers import ConformerConvolution

    if lay.tp == lay.sp == 1:
        return model
    check_widths(model_cfg or {}, lay.tp, type(model).__name__)
    if lay.sp > 1:
        model.seq_parallel = True
        model.encoder.seq_parallel = True
    if lay.tp == 1:
        return model
    local = shard_state_dict(model.state_dict(), lay.tp_i, lay.tp)
    with torch.no_grad():
        for key, tensor in local.items():
            mod_path, _, leaf = key.rpartition(".")
            mod = model.get_submodule(mod_path)
            cur = getattr(mod, leaf)
            if isinstance(cur, torch.nn.Parameter):
                cur.data = tensor.to(cur.device)
            else:
                setattr(mod, leaf, tensor.to(cur.device))
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            mod.h_total, mod.n_head = mod.n_head, mod.n_head // lay.tp
            mod.head0 = lay.tp_i * mod.n_head
            mod.tp = True
            mod.linear_o.tp_reduce = True
        elif isinstance(mod, PositionwiseFeedForward):
            mod.tp = True
            mod.fc2.tp_reduce = True
        elif isinstance(mod, ConformerConvolution):
            c = mod.depthwise_conv.weight.shape[0]
            mod.depthwise_conv.groups = mod.depthwise_conv.in_channels = c
            mod.depthwise_conv.out_channels = c
            mod.tp = True
            mod.pointwise_conv2.tp_reduce = True
    model.tp_sharded = True
    return model


def sharded_parameters(model: torch.nn.Module) -> List[bool]:
    """For each of ``model.named_parameters()``: whether tp shards it."""
    sharded = getattr(model, "tp_sharded", False)
    return [sharded and shard_dim(k, p.dim()) is not None for k, p in model.named_parameters()]
