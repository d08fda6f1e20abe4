"""wav2vec 2.0 contrastive pretraining model (liteasr_tpu/models/wav2vec2.py).

The conv feature extractor (/320), span masking with a learned mask
embedding, the transformer context network, Gumbel-VQ quantized targets,
``num_negatives`` in-sample negatives and cosine-similarity logits / 0.1.
As in the reference, every shape is fixed: the span mask is drawn on the
device per row (:func:`device_span_mask`) and the loss weights all frames
by it, with no boolean gather.

Random draws come from the model's CPU generators, seeded from the dropout
seed with salts by :meth:`Wav2Vec2.seed_dropout`: the span starts (and
widths), the negatives' uniforms (B, F, N) and the Gumbel noise. At eval
the mask and the negatives use fixed streams, as the reference falls back
to ``PRNGKey(0)`` / ``PRNGKey(1)`` when no rng is given. Each draw is a
method (:meth:`draw_mask`, :meth:`draw_negatives_uniform`,
:meth:`draw_gumbel_noise`), so that a test can hand in the reference's.

Under tensor parallelism the encoder layers are Megatron-sharded and the
rest is replicated. Under sequence parallelism (``seq_parallel``, set by
``parallel.sharding.shard_model``) every sp rank takes the whole padded
batch and works on its block of the frames: the extractor on the block's
sample window, the context network, the quantizer and the logits on the
block's frames. The draws are the whole rows' (the span mask, which the
negatives' pool needs whole; the uniforms and the Gumbel noise cut to the
block), and the quantized targets are gathered over the group, so that a
negative can be any frame of its row. Every rank's loss is then its share
of the one-process loss.
"""

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch import nn

from liteasr_tpu_torch.config import LiteasrDataclass
from liteasr_tpu_torch.models import LiteasrModel, register_model
from liteasr_tpu_torch.models.u2 import _DTYPES
from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.parallel import rank_seed, sharding
from liteasr_tpu_torch.nets.common import Dense, LayerNorm, dropout, lecun_normal_
from liteasr_tpu_torch.nets.wav2vec2 import (
    ConvFeatureExtractor, GumbelVectorQuantizer, Wav2Vec2TransformerEncoder,
    conv_output_length, sample_window, wide_float)

DEFAULT_CONV_LAYERS = "[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512,2,2)] + [(512,2,2)]"
# the mask, negatives and Gumbel generators are seeded with the dropout
# seed XOR these, so that the CPU generators draw independent streams
MASK_SEED_SALT = 0x2545F491
NEGATIVES_SEED_SALT = 0x4F6CDD1D
GUMBEL_SEED_SALT = 0x1B873593
# the eval-mode streams (the reference's PRNGKey(0) / PRNGKey(1) fallbacks)
EVAL_MASK_SEED, EVAL_NEGATIVES_SEED = 0, 1


@dataclass
class Wav2Vec2Config(LiteasrDataclass):
    """The reference's schema (liteasr_tpu/models/wav2vec2.py:34-72)."""

    name: Optional[str] = field(default="wav2vec2")

    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12

    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.0
    dropout_features: float = 0.0

    final_dim: int = 0
    conv_feature_layers: str = DEFAULT_CONV_LAYERS
    conv_bias: bool = False
    logit_temp: float = 0.1
    quantize_targets: bool = True
    latent_vars: int = 320
    latent_groups: int = 2
    latent_dim: int = 0

    mask_length: int = 10
    mask_prob: float = 0.65
    # span-width policy: static | uniform | normal | poisson
    mask_policy: str = "static"
    mask_other: float = 0.0
    no_mask_overlap: bool = False
    mask_min_space: int = 1

    num_negatives: int = 100
    negatives_from_everywhere: bool = False

    conv_pos: int = 128
    conv_pos_groups: int = 16

    latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)

    dtype: str = "float32"


# ----------------------------------------------------------- span mask


def span_mask_count(frame: int, prob: float, length: int, min_mask_num: int = 2) -> int:
    """Spans per row: the deterministic round of the reference's
    stochastically rounded ``int(prob * frame / length + rand())``."""
    return max(min_mask_num, int(prob * frame / float(length) + 0.5))


def span_widths(generator: Optional[torch.Generator], batch: int, mask_num: int,
                length: int, policy: str = "static", other: float = 0.0) -> torch.Tensor:
    """(B, M) int64 span widths on the CPU, by the reference's policies
    (liteasr/utils/mask.py:93-230): static = ``length``; uniform ~ U{0, ..,
    2 length}; normal ~ max(1, round(N(length, other))); poisson ~
    Poisson(length) by inverse CDF over a support capped at 4 length + 16,
    as the device path of liteasr_tpu/models/wav2vec2.py:116-126 does."""
    shape = (batch, mask_num)
    if policy == "static":
        return torch.full(shape, length, dtype=torch.int64)
    if policy == "uniform":
        return torch.randint(0, 2 * length + 1, shape, generator=generator)
    if policy == "normal":
        w = torch.randn(shape, generator=generator) * other + length
        return torch.clamp(torch.round(w), min=1).long()
    if policy == "poisson":
        support = torch.arange(4 * length + 16, dtype=torch.float32)
        logpmf = support * math.log(float(length)) - length - torch.lgamma(support + 1.0)
        cdf = torch.cumsum(torch.exp(logpmf), 0)
        u = torch.rand(shape, generator=generator)
        return torch.searchsorted(cdf, u * cdf[-1])
    raise ValueError(f"unknown mask selection {policy}")


def spans_to_mask(u: torch.Tensor, widths: torch.Tensor, frame: int,
                  flens: torch.Tensor) -> torch.Tensor:
    """(B, F) bool from the span draws: starts ``floor(u * max(flens -
    min_width, 1))`` in fp32, each span ``widths`` wide, cut at ``flens``
    (liteasr_tpu/models/wav2vec2.py:128-142)."""
    min_span = widths.min(dim=1).values
    span_max = torch.clamp(flens - min_span, min=1).float()
    starts = torch.floor(u * span_max[:, None]).long()[:, :, None]
    pos = torch.arange(frame, device=u.device)
    in_span = (pos >= starts) & (pos < starts + widths[:, :, None])
    return in_span.any(dim=1) & (pos[None, :] < flens[:, None])


def device_span_mask(generator: Optional[torch.Generator], batch: int, frame: int,
                     prob: float, length: int, min_mask_num: int = 2,
                     flens: Optional[torch.Tensor] = None, policy: str = "static",
                     other: float = 0.0) -> torch.Tensor:
    """Span mask (True = masked) of the reference's device path
    (liteasr_tpu/models/wav2vec2.py:77-142): ``span_mask_count`` spans per
    row, overlap allowed, starts drawn per row in the row's valid region
    ``flens`` (all ``frame`` if None), nothing masked past it. The uniforms
    and widths are drawn on the CPU from ``generator``, the mask is built
    on ``flens``'s device."""
    mask_num = span_mask_count(frame, prob, length, min_mask_num)
    u = torch.rand((batch, mask_num), generator=generator)
    widths = span_widths(generator, batch, mask_num, length, policy, other)
    if flens is None:
        flens = torch.full((batch,), frame, dtype=torch.int64)
    return spans_to_mask(place_draw(u, flens.device), place_draw(widths, flens.device),
                         frame, flens)


def place_draw(t: torch.Tensor, device) -> torch.Tensor:
    """A CPU draw on ``device``: through pinned memory and without blocking
    the host on a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# ----------------------------------------------------------- negatives


def negative_indices(u: torch.Tensor, mask: torch.Tensor, flens: torch.Tensor,
                     everywhere: bool = False, f0: int = 0) -> torch.Tensor:
    """(B, Fu, N) frame index of each negative of frames f0 .. f0 + Fu from
    their uniforms ``u`` (B, Fu, N), self-excluded, within the row
    (liteasr_tpu/models/wav2vec2.py:286-318); ``mask`` (B, F) is the whole
    rows'. The pool is the row's masked frames (their list by a stable
    argsort of ~mask, each frame's place in it by cumsum), or with
    ``everywhere`` its valid frames; the draw is ``floor(u * (pool - 1))``
    in fp32."""
    B, Fu, N = u.shape
    F = mask.shape[1]
    if everywhere:
        pool = torch.clamp(flens - 1, min=1)[:, None, None]
        draw = torch.floor(u * pool).long()
        self_pos = torch.arange(f0, f0 + Fu, device=u.device)[None, :, None]
        return torch.clamp(torch.where(draw >= self_pos, draw + 1, draw), 0, F - 1)
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    rank = (torch.cumsum(mask, dim=1) - 1)[:, f0:f0 + Fu]
    m_row = torch.clamp(mask.sum(dim=1), min=2)[:, None, None]
    draw = torch.floor(u * (m_row - 1)).long()
    draw = torch.where(draw >= rank[:, :, None], draw + 1, draw)
    draw = torch.minimum(torch.clamp(draw, min=0), m_row - 1)
    return torch.gather(order, 1, draw.reshape(B, Fu * N)).reshape(B, Fu, N)


# --------------------------------------------------------------- model


@register_model("wav2vec2", dataclass=Wav2Vec2Config)
class Wav2Vec2(LiteasrModel):
    def __init__(self, encoder_layers: int = 12, encoder_embed_dim: int = 768,
                 encoder_ffn_embed_dim: int = 3072, encoder_attention_heads: int = 12,
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 dropout_input: float = 0.0, dropout_features: float = 0.0,
                 final_dim: int = 0, conv_feature_layers: str = DEFAULT_CONV_LAYERS,
                 conv_bias: bool = False, logit_temp: float = 0.1, latent_vars: int = 320,
                 latent_groups: int = 2, latent_dim: int = 0, mask_length: int = 10,
                 mask_prob: float = 0.65, mask_policy: str = "static",
                 mask_other: float = 0.0, num_negatives: int = 100,
                 negatives_from_everywhere: bool = False, conv_pos: int = 128,
                 conv_pos_groups: int = 16,
                 latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995), *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        conv_layers = tuple(tuple(c) for c in eval(conv_feature_layers))  # noqa: S307
        self.conv_layers = conv_layers
        self.compute_dtype = dtype
        self.dropout_input = dropout_input
        self.dropout_features = dropout_features
        self.logit_temp = logit_temp
        self.mask_length = mask_length
        self.mask_prob = mask_prob
        self.mask_policy = mask_policy
        self.mask_other = mask_other
        self.num_negatives = num_negatives
        self.negatives_from_everywhere = negatives_from_everywhere
        self.latent_temp = tuple(latent_temp)

        kw = dict(dtype=dtype)
        embed_dim = conv_layers[-1][0]
        final_dim = final_dim if final_dim > 0 else encoder_embed_dim
        vq_dim = latent_dim if latent_dim > 0 else final_dim
        # parameters are drawn on the CPU, so that one seed gives the same
        # weights on every device
        self.feature_extractor = ConvFeatureExtractor(conv_layers, conv_bias, **kw)
        self.layer_norm = LayerNorm(embed_dim, **kw)
        self.linear_input = Dense(embed_dim, encoder_embed_dim, **kw)
        self.quantizer = GumbelVectorQuantizer(embed_dim, latent_vars, latent_groups,
                                               vq_dim, **kw)
        self.linear_quantizer = Dense(vq_dim, final_dim, **kw)
        self.mask_emb = nn.Parameter(torch.empty(encoder_embed_dim))
        self.encoder = Wav2Vec2TransformerEncoder(
            encoder_embed_dim, encoder_ffn_embed_dim, encoder_attention_heads,
            encoder_layers, dropout, attention_dropout, dropout, conv_pos,
            conv_pos_groups, **kw)
        self.linear_final = Dense(encoder_embed_dim, final_dim, **kw)
        self.mask_generator = torch.Generator()
        self.negatives_generator = torch.Generator()
        self.gumbel_generator = torch.Generator()
        self.init_params(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None):
        """flax's initializers, drawn from ``generator``: the codebook and
        ``mask_emb`` uniform [0, 1), ``weight_proj`` N(0, 1) with a zero
        bias, lecun-normal for every other dense and conv kernel (fan-in
        I/groups x K for a conv), zero biases; norms start at identity."""
        for module in self.modules():
            if isinstance(module, (Dense, nn.Conv1d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
        self.quantizer.weight_proj.weight.normal_(0.0, 1.0, generator=generator)
        self.quantizer.vars.uniform_(0.0, 1.0, generator=generator)
        self.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def seed_dropout(self, seed: int, rank: int = 0):
        """Seed the model's generators, each from a salted seed: the span
        mask, the negatives and the Gumbel noise, streams of ``rank``'s own
        rows (the dropouts follow ``torch.manual_seed``)."""
        self.mask_generator.manual_seed(rank_seed(seed ^ MASK_SEED_SALT, rank))
        self.negatives_generator.manual_seed(rank_seed(seed ^ NEGATIVES_SEED_SALT, rank))
        self.gumbel_generator.manual_seed(rank_seed(seed ^ GUMBEL_SEED_SALT, rank))

    # ---- the random draws

    def draw_mask(self, batch: int, frame: int, flens: torch.Tensor, train: bool):
        """(B, F) span mask of the whole rows on ``flens``'s device: from
        ``mask_generator`` in training, from the fixed eval stream otherwise
        (under a process group, the dp rank's rows of the global batch's
        draw, which its tp and sp peers share: each row is drawn and built
        alone, so the other rows' lengths do not matter)."""
        if train:
            return device_span_mask(self.mask_generator, batch, frame, self.mask_prob,
                                    self.mask_length, flens=flens,
                                    policy=self.mask_policy, other=self.mask_other)
        lay = parallel.layout()
        mask = device_span_mask(torch.Generator().manual_seed(EVAL_MASK_SEED),
                                batch * lay.dp, frame, self.mask_prob, self.mask_length,
                                flens=flens.repeat(lay.dp), policy=self.mask_policy,
                                other=self.mask_other)
        return mask[lay.dp_i * batch:(lay.dp_i + 1) * batch]

    def draw_negatives_uniform(self, batch: int, frame: int, train: bool, device):
        """(B, F, N) uniform [0, 1) fp32 of the negatives' draw (at eval
        under a process group, the dp rank's rows of the global draw)."""
        if train:
            u = torch.rand((batch, frame, self.num_negatives),
                           generator=self.negatives_generator)
        else:
            lay = parallel.layout()
            u = torch.rand((batch * lay.dp, frame, self.num_negatives),
                           generator=torch.Generator().manual_seed(EVAL_NEGATIVES_SEED))
            u = u[lay.dp_i * batch:(lay.dp_i + 1) * batch]
        return place_draw(u, device)

    def draw_gumbel_noise(self, n: int, device):
        """(n, V) standard Gumbel noise of the training quantizer,
        ``-log(-log(u))`` of uniforms from ``gumbel_generator`` clamped to
        fp32's tiny, as ``jax.random.gumbel``."""
        u = torch.rand((n, self.quantizer.num_vars), generator=self.gumbel_generator)
        u = place_draw(u, device).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    # ---- forward

    def feature_lengths(self, xlens: torch.Tensor) -> torch.Tensor:
        """Waveform sample counts -> conv frame counts, at least 1."""
        lens = xlens
        for _, kernel, stride in self.conv_layers:
            lens = (lens - kernel) // stride + 1
        return torch.clamp(lens, min=1)

    def forward(self, source, xlens=None, train: bool = False, temp=2.0):
        """source: (B, T) waveform; xlens: optional (B,) valid sample counts.

        Returns (logits (N+1, B, F), mask (B, F), code_probs (G, V)), the
        positive at candidate 0. ``mask`` is True only on masked valid
        frames; ``code_probs`` is the mask-weighted codebook usage. The
        host's draws come first, so that they overlap the device's work.
        Under sequence parallelism the logits and the mask are of the sp
        rank's block of the F frames, and ``code_probs`` sums every rank's."""
        B, T = source.shape
        F = conv_output_length(T, self.conv_layers)
        if xlens is not None:
            flens = torch.clamp(self.feature_lengths(xlens), max=F)
        else:
            flens = torch.full((B,), F, dtype=torch.int64, device=source.device)
        mask = self.draw_mask(B, F, flens, train)
        u = self.draw_negatives_uniform(B, F, train, source.device)
        gumbels = (self.draw_gumbel_noise(B * F * self.quantizer.groups, source.device)
                   if train else None)
        seq, lo, hi = None, 0, F
        if self.seq_parallel:  # the sp rank's frames and the samples they read
            seq = sharding.seq_shard(F)
            lo, hi = seq.lo, seq.hi
            a, b = sample_window(lo, hi, self.conv_layers)
            source, u = source[:, a:b], u[:, lo:hi]
            if gumbels is not None:
                gumbels = gumbels.view(B, F, -1, gumbels.shape[-1])[:, lo:hi].flatten(0, 2)
        own = mask[:, lo:hi]

        # 1. features
        features = self.layer_norm(self.feature_extractor(source))
        unmasked = dropout(features, self.dropout_features, train)
        features = dropout(self.linear_input(features), self.dropout_input, train)
        # 2. the learned mask embedding over the masked frames
        x = torch.where(own[:, :, None], self.mask_emb.to(features.dtype), features)
        # 3. context
        x = self.linear_final(self.encoder(x, train, seq))
        # 4. quantized targets of every frame, code usage weighted by the mask
        y, code_probs = self.quantizer(unmasked, temp, train, frame_weight=own,
                                       gumbels=gumbels)
        y = self.linear_quantizer(y)
        if seq is not None:  # any frame of the row may be a negative
            y = self.gather_frames(y, F)
        # 5. candidates: the positive, then the negatives
        idx = negative_indices(u, mask, flens, self.negatives_from_everywhere, lo)
        self_idx = torch.arange(lo, hi, device=idx.device)[None, :, None].expand(B, -1, 1)
        cand = torch.cat([self_idx, idx], dim=2).reshape(B, -1)
        rows = torch.arange(B, device=idx.device)[:, None]
        tgt = y[rows, cand].reshape(B, hi - lo, self.num_negatives + 1, -1)
        return self.compute_logits(x, tgt), own, code_probs

    def compute_logits(self, x, tgt):
        """Cosine similarity / ``logit_temp`` in fp32 (liteasr_tpu/models/
        wav2vec2.py:338-349): x (B, F, D), tgt (B, F, N+1, D) with the
        positive first -> (N+1, B, F); -inf where a negative equals the
        positive bit for bit."""
        wide = wide_float(x.dtype)
        x32, tgt32 = x.to(wide), tgt.to(wide)
        dot = torch.matmul(tgt32, x32[..., None])[..., 0]
        norm = (torch.linalg.vector_norm(x32, dim=-1)[..., None]
                * torch.linalg.vector_norm(tgt32, dim=-1))
        logits = dot / torch.clamp(norm, min=1e-8) / self.logit_temp
        neg_is_pos = (tgt[:, :, 1:] == tgt[:, :, :1]).all(dim=-1)
        logits = torch.cat([logits[..., :1],
                            logits[..., 1:].masked_fill(neg_is_pos, float("-inf"))], -1)
        return logits.permute(2, 0, 1)

    def get_pred_len(self, xlens):
        return xlens

    def get_target(self, ys, ylens):
        return ys

    @staticmethod
    def _normalize_conv_layers(cl) -> str:
        """``conv_feature_layers`` as a python-literal string, whether the
        CLI/YAML gave a string, a parsed list, or yaml-mangled fragments
        like ['(512', '10', '5)']."""
        if isinstance(cl, str):
            layers = eval(cl)  # noqa: S307
        elif any(isinstance(x, (str, int)) for x in cl):
            layers = eval("[" + ",".join(str(x) for x in cl) + "]")  # noqa: S307
        else:
            layers = [tuple(x) for x in cl]
        return repr([tuple(layer) for layer in layers])

    @classmethod
    def build_model(cls, cfg, task=None, device=None, generator=None):
        """Build from the composed config."""
        lt = cfg.latent_temp
        if isinstance(lt, str):
            lt = tuple(eval(lt))  # noqa: S307
        cfg.conv_feature_layers = cls._normalize_conv_layers(cfg.conv_feature_layers)
        dtype = str(cfg.get("dtype", "float32"))
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported model.dtype {dtype!r}")
        return cls(
            encoder_layers=int(cfg.encoder_layers),
            encoder_embed_dim=int(cfg.encoder_embed_dim),
            encoder_ffn_embed_dim=int(cfg.encoder_ffn_embed_dim),
            encoder_attention_heads=int(cfg.encoder_attention_heads),
            dropout=float(cfg.dropout),
            attention_dropout=float(cfg.attention_dropout),
            dropout_input=float(cfg.dropout_input),
            dropout_features=float(cfg.dropout_features),
            final_dim=int(cfg.final_dim),
            conv_feature_layers=cfg.conv_feature_layers,
            conv_bias=bool(cfg.conv_bias),
            logit_temp=float(cfg.logit_temp),
            latent_vars=int(cfg.latent_vars),
            latent_groups=int(cfg.latent_groups),
            latent_dim=int(cfg.latent_dim),
            mask_length=int(cfg.mask_length),
            mask_prob=float(cfg.mask_prob),
            mask_policy=str(cfg.get("mask_policy", "static")),
            mask_other=float(cfg.get("mask_other", 0.0)),
            num_negatives=int(cfg.num_negatives),
            negatives_from_everywhere=bool(cfg.negatives_from_everywhere),
            conv_pos=int(cfg.conv_pos),
            conv_pos_groups=int(cfg.conv_pos_groups),
            latent_temp=tuple(float(v) for v in lt),
            dtype=_DTYPES[dtype],
            device=device,
            generator=generator,
        )
