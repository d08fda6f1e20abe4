"""Plain PyTorch U2 conformer (WeNet's hybrid CTC/attention model as the
port defines it) for the benchmark's correctness check: its layout, its
train-mode forward and loss, its eval-mode encoder, CTC head and
rescoring decoder, and one clipped Adam update. Functional, over a dict
of fp32 leaves named as the port's ``state_dict``; no kernel, no cache,
no batching tricks. Imports nothing of the port.

``precision="fp8"`` rounds both operands of every product (linear layers,
convolutions, attention) to float8 e4m3 with a per-tensor scale before an
fp32 product, and the gradient into each product's backward to e5m2: the
control, one step of precision below the bf16 the configuration states.
"""

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.draws import attention_keep
from weights import Layout

LN_EPS = 1e-12
BN_EPS = 1e-5
NEG_INF = -1e30
MASK_FILL = -1e38
IGNORE = -1


def layout(m: Dict) -> Layout:
    """(name, shape, init) of every parameter, in the port's order."""
    d, ff, V, F_in = m["enc_dim"], m["enc_ff_dim"], m["vocab_size"], m["input_dim"]
    H, k = m["enc_attn_heads"], m["conv_kernel"]
    f_sub = ((F_in - 1) // 2 - 1) // 2
    out: Layout = []

    def dense(name, i, o, bias=True):
        out.append((f"{name}.weight", (o, i), "normal"))
        if bias:
            out.append((f"{name}.bias", (o,), "zeros"))

    def norm(name, c):
        out.append((f"{name}.weight", (c,), "ones"))
        out.append((f"{name}.bias", (c,), "zeros"))

    def ffn(name, dim, hid):
        dense(f"{name}.fc1", dim, hid)
        dense(f"{name}.fc2", hid, dim)

    def mha(name, dim, rel):
        for p in ("linear_q", "linear_k", "linear_v", "linear_o"):
            dense(f"{name}.{p}", dim, dim)
        if rel:
            dense(f"{name}.linear_pos", dim, dim, bias=False)
            out.append((f"{name}.pos_bias_u", (H, dim // H), "normal"))
            out.append((f"{name}.pos_bias_v", (H, dim // H), "normal"))

    out.append(("encoder.embed.conv1.weight", (d, 1, 3, 3), "normal"))
    out.append(("encoder.embed.conv1.bias", (d,), "zeros"))
    out.append(("encoder.embed.conv2.weight", (d, d, 3, 3), "normal"))
    out.append(("encoder.embed.conv2.bias", (d,), "zeros"))
    dense("encoder.embed.out", d * f_sub, d)
    for i in range(m["enc_layers"]):
        p = f"encoder.layer_{i}"
        norm(f"{p}.self_attn_norm", d)
        mha(f"{p}.self_attn", d, True)
        norm(f"{p}.feed_forward_norm", d)
        ffn(f"{p}.feed_forward", d, ff)
        norm(f"{p}.feed_forward_macaron_norm", d)
        ffn(f"{p}.feed_forward_macaron", d, ff)
        norm(f"{p}.conv_norm", d)
        dense(f"{p}.conv.pointwise_conv1", d, 2 * d)
        out.append((f"{p}.conv.depthwise_conv.weight", (d, 1, k), "normal"))
        out.append((f"{p}.conv.depthwise_conv.bias", (d,), "zeros"))
        norm(f"{p}.conv.norm", d)
        dense(f"{p}.conv.pointwise_conv2", d, d)
        norm(f"{p}.final_norm", d)
    norm("encoder.after_norm", d)
    dd, dff = m["dec_dim"], m["dec_ff_dim"]
    out.append(("decoder.embed.weight", (V, dd), "normal"))
    for i in range(m["dec_layers"]):
        p = f"decoder.layer_{i}"
        norm(f"{p}.self_attn_norm", dd)
        mha(f"{p}.self_attn", dd, False)
        norm(f"{p}.src_attn_norm", dd)
        mha(f"{p}.src_attn", dd, False)
        norm(f"{p}.feed_forward_norm", dd)
        ffn(f"{p}.feed_forward", dd, dff)
    norm("decoder.after_norm", dd)
    dense("decoder.linear_out", dd, V)
    dense("ctc_lo", d, V)
    return out


# ---------------------------------------------------------------- products

def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to an fp8 ``dtype`` at the per-tensor scale that maps
    its largest magnitude to ``top``."""
    scale = top / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(torch.float32) / scale


def _q8(t: torch.Tensor) -> torch.Tensor:
    """A product's operand in float8 e4m3 (largest 448); its gradient
    passes through."""
    q = _round(t.detach(), torch.float8_e4m3fn, 448.0)
    return t + (q - t.detach())


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to float8
    e5m2 (largest 57,344), as fp8 training feeds its backward products."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Ops:
    """The products of one precision: fp32 (the reference) or fp8 (the
    control: e4m3 operands forward, e5m2 gradients into each product's
    backward, fp32 accumulation)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def _p(self, fn, *operands, **kw):
        if not self.fp8:
            return fn(*operands, **kw)
        return _GradE5M2.apply(fn(*[o if o is None or isinstance(o, str) else _q8(o)
                                     for o in operands], **kw))

    def linear(self, x, P, name, bias=True):
        y = self._p(F.linear, x, P[f"{name}.weight"])
        return y + P[f"{name}.bias"] if bias else y

    def einsum(self, eq, a, b):
        return self._p(torch.einsum, eq, a, b)

    def conv2d(self, x, w, b, stride):
        return self._p(F.conv2d, x, w, stride=stride) + b[:, None, None]

    def conv1d(self, x, w, b, padding, groups):
        return self._p(F.conv1d, x, w, padding=padding, groups=groups) + b[:, None]

    def conv1d_strided(self, x, w, stride):
        return self._p(F.conv1d, x, w, stride=stride)

    def matmul(self, a, b):
        return self._p(torch.matmul, a, b)


def layer_norm(x, P, name):
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS) * P[f"{name}.weight"] + P[f"{name}.bias"]


def swish(x):
    return x * torch.sigmoid(x)


def sinusoidal_pe(length: int, dim: int, device) -> torch.Tensor:
    """(1, length, dim), sin and cos interleaved."""
    pos = torch.arange(length, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    rad = pos[:, None] * div
    return torch.stack([torch.sin(rad), torch.cos(rad)], dim=-1).reshape(1, length, dim)


def rel_shift(x):
    *lead, t1, t2 = x.shape
    x_padded = torch.cat([x.new_zeros(*lead, t1, 1), x], dim=-1)
    x_padded = x_padded.reshape(*lead, t2 + 1, t1)
    return x_padded[..., 1:, :].reshape(*lead, t1, t2)


def subsample_mask(mask):
    return mask[:, :-2:2][:, :-2:2]


def padding_mask(lens, max_len: int):
    return torch.arange(max_len, device=lens.device)[None, :] >= lens[:, None]


# ------------------------------------------------------------------ model

class U2Reference:
    """The forward passes over leaves ``P``. Train mode takes the step's
    draws: ``drop`` (the plain dropouts' masks, :class:`draws.Dropouts`)
    and ``attn_seeds`` (the attention kernels' hash seeds,
    :class:`draws.SeedStream`); ``remat`` recomputes each layer in the
    backward, to fit the largest batches."""

    def __init__(self, m: Dict, ops: Ops):
        self.m, self.ops = m, ops
        # each site's rate, defaulting as the port's config does: the
        # encoder's and decoder's to ``dropout_rate`` (the CTC head's),
        # their parts to theirs
        r = float(m["dropout_rate"])
        enc, dec = (float(m.get(f"{s}_dropout_rate", r)) for s in ("enc", "dec"))
        self.rate = {"ctc": r, "enc": enc, "dec": dec}
        for site, default in (("enc_pos", enc), ("enc_attn", enc), ("enc_ff", enc),
                              ("dec_pos", dec), ("dec_self_attn", dec),
                              ("dec_src_attn", dec), ("dec_ff", dec)):
            self.rate[site] = float(m.get(f"{site}_dropout_rate", default))
        self.H = m["enc_attn_heads"]
        self.V = m["vocab_size"]

    # ---- pieces

    def ffn(self, x, P, name, drop, rate, act=swish):
        h = act(self.ops.linear(x, P, f"{name}.fc1"))
        if drop is not None:
            h = drop(h, rate)
        return self.ops.linear(h, P, f"{name}.fc2")

    def rel_attention(self, y, pos_emb, P, name, kv_lens, seed):
        B, T, D = y.shape
        H, Dk = self.H, D // self.H
        q = self.ops.linear(y, P, f"{name}.linear_q").reshape(B, T, H, Dk)
        k = self.ops.linear(y, P, f"{name}.linear_k").reshape(B, T, H, Dk)
        v = self.ops.linear(y, P, f"{name}.linear_v").reshape(B, T, H, Dk)
        p = self.ops.linear(pos_emb, P, f"{name}.linear_pos", bias=False).reshape(T, H, Dk)
        q_u = (q + P[f"{name}.pos_bias_u"]).permute(0, 2, 1, 3)
        q_v = (q + P[f"{name}.pos_bias_v"]).permute(0, 2, 1, 3)
        k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        ac = self.ops.einsum("bhqd,bhkd->bhqk", q_u, k)
        bd = rel_shift(self.ops.einsum("bhqd,khd->bhqk", q_v, p))
        s = (ac + bd) * Dk ** -0.5
        j = torch.arange(T, device=y.device)
        s = s.masked_fill(j[None, None, None, :] >= kv_lens[:, None, None, None], NEG_INF)
        a = torch.softmax(s, dim=-1)
        rate = self.rate["enc_attn"]
        if seed is not None and rate > 0.0:
            keep = attention_keep(B * H, T, T, seed, rate, y.device).view(B, H, T, T)
            a = torch.where(keep, a, 0.0) / (1.0 - rate)
        out = self.ops.einsum("bhqk,bhkd->bhqd", a, v).permute(0, 2, 1, 3).reshape(B, T, D)
        return self.ops.linear(out, P, f"{name}.linear_o")

    def mha(self, q_in, kv_in, mask, P, name, drop, rate):
        B, Tq, D = q_in.shape
        H, Dk = self.m["dec_attn_heads"], D // self.m["dec_attn_heads"]
        q = self.ops.linear(q_in, P, f"{name}.linear_q").reshape(B, Tq, H, Dk)
        k = self.ops.linear(kv_in, P, f"{name}.linear_k").reshape(B, -1, H, Dk)
        v = self.ops.linear(kv_in, P, f"{name}.linear_v").reshape(B, -1, H, Dk)
        s = self.ops.einsum("bqhd,bkhd->bhqk", q, k) * Dk ** -0.5
        if mask is not None:
            s = s.masked_fill(mask, MASK_FILL)
        a = torch.softmax(s, dim=-1)
        if drop is not None:
            a = drop(a, rate)
        x = self.ops.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, Tq, D)
        return self.ops.linear(x, P, f"{name}.linear_o")

    def conv_module(self, x, P, name, train):
        x = F.glu(self.ops.linear(x, P, f"{name}.pointwise_conv1"), dim=-1)
        w = P[f"{name}.depthwise_conv.weight"]
        x = self.ops.conv1d(x.transpose(1, 2), w, P[f"{name}.depthwise_conv.bias"],
                            (w.shape[-1] - 1) // 2, w.shape[0]).transpose(1, 2)
        if train:
            mean = x.mean(dim=(0, 1))
            var = ((x - mean) ** 2).mean(dim=(0, 1))
        else:  # the running statistics of a model that has not trained: 0 and 1
            mean, var = torch.zeros((), device=x.device), torch.ones((), device=x.device)
        x = (x - mean) * torch.rsqrt(var + BN_EPS) * P[f"{name}.norm.weight"] \
            + P[f"{name}.norm.bias"]
        return self.ops.linear(swish(x), P, f"{name}.pointwise_conv2")

    def conformer_layer(self, x, pos_emb, P, name, kv_lens, drop, seed, train=True):
        def res(x, norm, fn, scale=1.0):
            y = fn(layer_norm(x, P, f"{name}.{norm}"))
            return x + scale * (drop(y, self.rate["enc"]) if drop is not None else y)

        ff = self.rate["enc_ff"]
        x = res(x, "feed_forward_macaron_norm",
                lambda y: self.ffn(y, P, f"{name}.feed_forward_macaron", drop, ff), 0.5)
        x = res(x, "self_attn_norm",
                lambda y: self.rel_attention(y, pos_emb, P, f"{name}.self_attn", kv_lens,
                                             seed))
        x = res(x, "conv_norm", lambda y: self.conv_module(y, P, f"{name}.conv", train))
        x = res(x, "feed_forward_norm",
                lambda y: self.ffn(y, P, f"{name}.feed_forward", drop, ff), 0.5)
        return layer_norm(x, P, f"{name}.final_norm")

    # ---- the model

    def encode(self, P, xs, xlens, drop=None, attn_seeds=None, remat=False):
        """(B, T', D) encoder output and its (B, T') padding mask; train
        mode (batch statistics) with ``drop``, eval mode without."""
        ops = self.ops
        x = F.relu(ops.conv2d(xs[:, None], P["encoder.embed.conv1.weight"],
                              P["encoder.embed.conv1.bias"], 2))
        x = F.relu(ops.conv2d(x, P["encoder.embed.conv2.weight"],
                              P["encoder.embed.conv2.bias"], 2))
        b, c, t, f = x.shape
        x = ops.linear(x.permute(0, 2, 3, 1).reshape(b, t, f * c), P, "encoder.embed.out")
        d = x.shape[-1]
        pos_emb = sinusoidal_pe(t, d, x.device)
        x = x * math.sqrt(d)
        if drop is not None:
            x, pos_emb = drop(x, self.rate["enc_pos"]), drop(pos_emb, self.rate["enc_pos"])
        mask = subsample_mask(padding_mask(xlens, xs.shape[1]))
        kv_lens = (~mask).sum(dim=-1)
        for i in range(self.m["enc_layers"]):
            name = f"encoder.layer_{i}"
            seed = attn_seeds.next(self.rate["enc_attn"]) if attn_seeds is not None else None
            if remat:
                start = drop.index if drop is not None else 0

                def layer(x, pos_emb, name=name, start=start, seed=seed):
                    if drop is not None:
                        drop.index = start  # the recompute draws the same masks
                    return self.conformer_layer(x, pos_emb, P, name, kv_lens, drop, seed)

                x = checkpoint(layer, x, pos_emb, use_reentrant=False)
            else:
                x = self.conformer_layer(x, pos_emb, P, name, kv_lens, drop, seed,
                                         train=drop is not None)
        return layer_norm(x, P, "encoder.after_norm"), mask

    def decode(self, P, ys_in, h_enc, self_mask, enc_mask, drop=None):
        """Decoder logits (B, L, V) of ``ys_in`` over ``h_enc``."""
        ops, d = self.ops, self.m["dec_dim"]
        y = F.embedding(ys_in, P["decoder.embed.weight"])
        y = y * math.sqrt(d) + sinusoidal_pe(y.shape[1], d, y.device)
        if drop is not None:
            y = drop(y, self.rate["dec_pos"])
        src_mask = enc_mask[:, None, None, :]
        for i in range(self.m["dec_layers"]):
            p = f"decoder.layer_{i}"

            def res(y, norm, fn):
                z = fn(layer_norm(y, P, f"{p}.{norm}"))
                return y + (drop(z, self.rate["dec"]) if drop is not None else z)

            r = self.rate
            y = res(y, "self_attn_norm", lambda z: self.mha(
                z, z, self_mask, P, f"{p}.self_attn", drop, r["dec_self_attn"]))
            y = res(y, "src_attn_norm", lambda z: self.mha(
                z, h_enc, src_mask, P, f"{p}.src_attn", drop, r["dec_src_attn"]))
            y = res(y, "feed_forward_norm", lambda z: self.ffn(
                z, P, f"{p}.feed_forward", drop, r["dec_ff"], F.relu))
        return ops.linear(layer_norm(y, P, "decoder.after_norm"), P, "decoder.linear_out")

    def ctc_logits(self, P, h_enc, drop=None):
        return self.ops.linear(drop(h_enc, self.rate["ctc"]) if drop is not None else h_enc,
                               P, "ctc_lo")

    def loss(self, P, batch, drop, attn_seeds, ctc_weight, smoothing, remat=False):
        """The train-mode hybrid loss of one batch: 0.3 CTC + 0.7
        label-smoothed attention KL (as set), each summed over the real
        utterances and divided by their count."""
        xs, xlens, ys, ylens = batch["xs"], batch["xlens"], batch["ys"], batch["ylens"]
        valid = batch["valid"]
        nutt = torch.clamp(valid.sum(), min=1.0)
        h_enc, enc_mask = self.encode(P, xs, xlens, drop, attn_seeds, remat)
        B, L = ys.shape
        eos = self.V - 1
        ys_ = torch.where(ys == IGNORE, eos, ys)
        ys_in = torch.cat([torch.full((B, 1), eos, dtype=ys.dtype, device=ys.device), ys_], 1)
        causal = torch.triu(torch.ones(L + 1, L + 1, dtype=torch.bool, device=ys.device), 1)
        self_mask = (padding_mask(ylens + 1, L + 1)[:, None, :] | causal[None])[:, None]
        h_attn = self.decode(P, ys_in, h_enc, self_mask, enc_mask, drop)
        h_ctc = self.ctc_logits(P, h_enc, drop)
        # attention: KL(label-smoothed target || softmax) over the non-ignored positions
        tgt = torch.cat([ys, torch.full((B, 1), IGNORE, dtype=ys.dtype, device=ys.device)], 1)
        tgt[torch.arange(B, device=ys.device), ylens] = eos
        tgt = torch.where(valid[:, None] > 0, tgt, IGNORE).reshape(-1)
        ignore = tgt == IGNORE
        logp = torch.log_softmax(h_attn.reshape(-1, self.V), dim=-1)
        off, on = smoothing / (self.V - 1), 1.0 - smoothing
        true = torch.full_like(logp, off)
        true.scatter_(1, torch.where(ignore, 0, tgt)[:, None], on)
        kl = (true * (torch.log(true) - logp)).sum(dim=-1)
        loss_attn = torch.where(ignore, 0.0, kl).sum() / nutt
        # CTC over the feasible real utterances
        tgt_ctc = torch.where(ys == IGNORE, 0, ys)
        pred_len = ((xlens - 1) // 2 - 1) // 2
        lp = torch.log_softmax(h_ctc, dim=-1).transpose(0, 1)
        per_utt = F.ctc_loss(lp, tgt_ctc, pred_len, ylens, blank=0, reduction="none",
                             zero_infinity=True)
        pos = torch.arange(L, device=ys.device)[None, :]
        repeats = ((tgt_ctc[:, 1:] == tgt_ctc[:, :-1]) & (pos[:, 1:] < ylens[:, None])).sum(1)
        feasible = (pred_len >= ylens + repeats).float()
        loss_ctc = (per_utt * valid * feasible).sum() / nutt
        return ctc_weight * loss_ctc + (1 - ctc_weight) * loss_attn


def adam_update(P: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float,
                b1: float, b2: float, eps: float, clip: float) -> Dict[str, torch.Tensor]:
    """One Adam step from zero moments on the mean gradient ``grads``,
    after clipping its global norm to ``clip``: the fp32 leaves after it."""
    gsq = sum(g.double().square().sum() for g in grads.values())
    scale = min(clip / max(math.sqrt(float(gsq)), 1e-12), 1.0) if clip > 0 else 1.0
    out = {}
    for name, g in grads.items():
        g = g * scale
        mu_hat = (1 - b1) * g / (1 - b1)
        nu_hat = (1 - b2) * g * g / (1 - b2)
        out[name] = P[name] - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return out


def noam_lr(count: int, model_dim: int, factor: float, warmup: int) -> float:
    s = float(max(count + 1, 1))
    return factor * model_dim ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)

