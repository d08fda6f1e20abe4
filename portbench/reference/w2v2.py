"""Plain PyTorch wav2vec 2.0 BASE pretraining (the port's ``wav2vec2``
model and ``wav2vec`` criterion) for the benchmark's correctness check:
its layout, its train-mode loss and its random draws. Functional, over a
dict of fp32 leaves named as the port's ``state_dict``; imports nothing
of the port.

The draws follow the port's three CPU generators, seeded from the run's
seed with the port's salts: the span starts, the negatives' uniforms and
the Gumbel noise, in the order a micro-step takes them. The span mask
and the negatives' indices are frozen copies of the port's
``spans_to_mask`` and ``negative_indices``.
"""

from typing import Dict

import torch
import torch.nn.functional as F

from reference.u2 import Ops, layer_norm
from weights import Layout

MASK_SEED_SALT = 0x2545F491
NEGATIVES_SEED_SALT = 0x4F6CDD1D
GUMBEL_SEED_SALT = 0x1B873593


def conv_layers(m: Dict):
    return [tuple(c) for c in eval(m["conv_feature_layers"])]  # noqa: S307


def layout(m: Dict) -> Layout:
    d, ff = m["encoder_embed_dim"], m["encoder_ffn_embed_dim"]
    G, V = m["latent_groups"], m["latent_vars"]
    final = m.get("final_dim") or d
    out: Layout = []

    def dense(name, i, o):
        out.extend([(f"{name}.weight", (o, i), "normal"), (f"{name}.bias", (o,), "zeros")])

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros")])

    c_in = 1
    for i, (dim, k, _) in enumerate(conv_layers(m)):
        out.append((f"feature_extractor.conv_{i}.weight", (dim, c_in, k), "normal"))
        norm(f"feature_extractor.ln_{i}", dim)
        c_in = dim
    norm("layer_norm", c_in)
    dense("linear_input", c_in, d)
    out.append(("quantizer.vars", (1, G * V, final // G), "uniform"))
    out.append(("quantizer.weight_proj.weight", (G * V, c_in), "normal1"))
    out.append(("quantizer.weight_proj.bias", (G * V,), "zeros"))
    dense("linear_quantizer", final, final)
    out.append(("mask_emb", (d,), "uniform"))
    out.append(("encoder.pos_conv.weight", (d, d // m["conv_pos_groups"], m["conv_pos"]),
                "normal"))
    out.append(("encoder.pos_conv.bias", (d,), "zeros"))
    norm("encoder.embed_norm", d)
    for i in range(m["encoder_layers"]):
        p = f"encoder.layer_{i}"
        norm(f"{p}.self_attn_norm", d)
        for lin in ("linear_q", "linear_k", "linear_v", "linear_o"):
            dense(f"{p}.self_attn.{lin}", d, d)
        norm(f"{p}.feed_forward_norm", d)
        dense(f"{p}.feed_forward.fc1", d, ff)
        dense(f"{p}.feed_forward.fc2", ff, d)
    dense("linear_final", d, final)
    return out


# ------------------------------------------------------------------ draws

class Draws:
    """The port's three generators of one run, in the order its
    micro-steps take them."""

    def __init__(self, seed: int):
        self.mask = torch.Generator().manual_seed(int(seed) ^ MASK_SEED_SALT)
        self.negatives = torch.Generator().manual_seed(int(seed) ^ NEGATIVES_SEED_SALT)
        self.gumbel = torch.Generator().manual_seed(int(seed) ^ GUMBEL_SEED_SALT)

    def step(self, m: Dict, B: int, F_: int, device):
        """(span-start uniforms (B, M), negatives' uniforms (B, F, N),
        Gumbel noise (B F G, V)) of one micro-step."""
        M = max(2, int(m["mask_prob"] * F_ / float(m["mask_length"]) + 0.5))
        u_mask = torch.rand((B, M), generator=self.mask)
        u_neg = torch.rand((B, F_, m["num_negatives"]), generator=self.negatives)
        u = torch.rand((B * F_ * m["latent_groups"], m["latent_vars"]), generator=self.gumbel)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return u_mask.to(device), u_neg.to(device), (-torch.log(-torch.log(u))).to(device)


def spans_to_mask(u, widths, frame: int, flens):
    min_span = widths.min(dim=1).values
    span_max = torch.clamp(flens - min_span, min=1).float()
    starts = torch.floor(u * span_max[:, None]).long()[:, :, None]
    pos = torch.arange(frame, device=u.device)
    in_span = (pos >= starts) & (pos < starts + widths[:, :, None])
    return in_span.any(dim=1) & (pos[None, :] < flens[:, None])


def negative_indices(u, mask):
    B, Fu, N = u.shape
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    rank = torch.cumsum(mask, dim=1) - 1
    m_row = torch.clamp(mask.sum(dim=1), min=2)[:, None, None]
    draw = torch.floor(u * (m_row - 1)).long()
    draw = torch.where(draw >= rank[:, :, None], draw + 1, draw)
    draw = torch.minimum(torch.clamp(draw, min=0), m_row - 1)
    return torch.gather(order, 1, draw.reshape(B, Fu * N)).reshape(B, Fu, N)


def temperature(m: Dict, step: int) -> float:
    start, end, decay = m["latent_temp"]
    power = torch.pow(torch.tensor(decay, dtype=torch.float32), torch.tensor(float(step)))
    return torch.clamp(start * power, min=end)


# ------------------------------------------------------------------ model

def gelu(x):
    return F.gelu(x, approximate="tanh")


class W2V2Reference:
    def __init__(self, m: Dict, ops: Ops):
        self.m, self.ops = m, ops
        self.rate = float(m["dropout"])
        self.attn_rate = float(m["attention_dropout"])
        self.input_rate = float(m["dropout_input"])
        self.features_rate = float(m["dropout_features"])

    def loss(self, P, batch, drop, draws: Draws, step: int, diversity_weight: float):
        """The micro-step's contrastive loss plus the diversity term, and
        the codebook perplexity (summed over the groups, detached)."""
        m, ops = self.m, self.ops
        xs, xlens, valid = batch["xs"], batch["xlens"], batch["valid"]
        B, T = xs.shape
        layers = conv_layers(m)
        Fr, lens = T, xlens
        for _, k, s in layers:
            Fr = (Fr - k) // s + 1
            lens = (lens - k) // s + 1
        flens = torch.clamp(torch.clamp(lens, min=1), max=Fr)
        u_mask, u_neg, gumbels = draws.step(m, B, Fr, xs.device)
        widths = torch.full(u_mask.shape, m["mask_length"], dtype=torch.int64, device=xs.device)
        mask = spans_to_mask(u_mask, widths, Fr, flens)

        x = xs[:, :, None]
        for i, (_, _, s) in enumerate(layers):
            x = ops.conv1d_strided(x.transpose(1, 2), P[f"feature_extractor.conv_{i}.weight"],
                                   s).transpose(1, 2)
            x = gelu(layer_norm(x, P, f"feature_extractor.ln_{i}"))
        features = layer_norm(x, P, "layer_norm")
        # the port's order: the quantizer's input first, then the encoder's
        unmasked = drop(features, self.features_rate)
        feats = drop(ops.linear(features, P, "linear_input"), self.input_rate)
        x = torch.where(mask[:, :, None], P["mask_emb"], feats)
        x = ops.linear(self.encode(x, P, drop), P, "linear_final")

        G, V = m["latent_groups"], m["latent_vars"]
        logits = ops.linear(unmasked, P, "quantizer.weight_proj").reshape(B * Fr * G, V)
        probs = torch.softmax(logits.reshape(B * Fr, G, V), dim=-1)
        w = mask.float().reshape(B * Fr, 1, 1)
        avg_probs = (probs * w).sum(dim=0) / torch.clamp(w.sum().detach(), min=1.0)
        y_soft = torch.softmax((logits + gumbels) / temperature(m, step), dim=-1)
        hard = F.one_hot(torch.argmax(y_soft, dim=-1), V).float()
        x_sel = hard + (y_soft - y_soft.detach())
        y = torch.einsum("ngv,gvd->ngd", x_sel.reshape(B * Fr, G, V),
                         P["quantizer.vars"].reshape(G, V, -1)).reshape(B, Fr, -1)
        y = ops.linear(y, P, "linear_quantizer")

        idx = negative_indices(u_neg, mask)
        self_idx = torch.arange(Fr, device=xs.device)[None, :, None].expand(B, -1, 1)
        cand = torch.cat([self_idx, idx], dim=2).reshape(B, -1)
        tgt = y[torch.arange(B, device=xs.device)[:, None], cand].reshape(
            B, Fr, m["num_negatives"] + 1, -1)
        dot = ops.matmul(tgt, x[..., None])[..., 0]
        norm = (torch.linalg.vector_norm(x, dim=-1)[..., None]
                * torch.linalg.vector_norm(tgt, dim=-1))
        cos = dot / torch.clamp(norm, min=1e-8) / m["logit_temp"]
        neg_is_pos = (tgt[:, :, 1:] == tgt[:, :, :1]).all(dim=-1)
        cos = torch.cat([cos[..., :1], cos[..., 1:].masked_fill(neg_is_pos, float("-inf"))], -1)
        nll = -torch.log_softmax(cos, dim=-1)[..., 0]
        weight = mask.float() * valid[:, None]
        loss = (nll * weight).sum() / torch.clamp(weight.sum(), min=1.0)
        ppl = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-9), dim=-1))
        n_codes = G * V
        return (loss + diversity_weight * (n_codes - ppl.sum()) / n_codes,
                ppl.sum().detach())

    def encode(self, x, P, drop):
        """The conv positional embedding, ``embed_norm``, dropout, then the
        pre-LN transformer layers (relu FF, no final norm)."""
        w = P["encoder.pos_conv.weight"]
        pos = self.ops.conv1d(x.transpose(1, 2), w, P["encoder.pos_conv.bias"],
                              w.shape[-1] // 2, self.m["conv_pos_groups"]).transpose(1, 2)
        h = drop(layer_norm(x + gelu(pos[:, : x.shape[1]]), P, "encoder.embed_norm"),
                 self.rate)
        H = self.m["encoder_attention_heads"]
        for i in range(self.m["encoder_layers"]):
            p = f"encoder.layer_{i}"
            z = layer_norm(h, P, f"{p}.self_attn_norm")
            B, T, D = z.shape
            q, k, v = (self.ops.linear(z, P, f"{p}.self_attn.{n}").reshape(B, T, H, D // H)
                       for n in ("linear_q", "linear_k", "linear_v"))
            s = self.ops.einsum("bqhd,bkhd->bhqk", q, k) * (D // H) ** -0.5
            a = drop(torch.softmax(s, dim=-1), self.attn_rate)
            o = self.ops.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, D)
            h = h + drop(self.ops.linear(o, P, f"{p}.self_attn.linear_o"), self.rate)
            z = layer_norm(h, P, f"{p}.feed_forward_norm")
            f = drop(F.relu(self.ops.linear(z, P, f"{p}.feed_forward.fc1")), self.rate)
            h = h + drop(self.ops.linear(f, P, f"{p}.feed_forward.fc2"), self.rate)
        return h


def conv_frames(m: Dict, samples: int) -> int:
    for _, k, s in conv_layers(m):
        samples = (samples - k) // s + 1
    return samples

