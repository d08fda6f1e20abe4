"""Paraformer: the non-autoregressive CIF model
(liteasr_tpu/models/paraformer.py). Special ids: eos = V-1, ignore = -1.

A rel-pos conformer encoder, the CIF predictor and a parallel decoder.
``forward`` is the two-pass glancing training forward: pass 1 decodes the
CIF vectors without gradients (``torch.no_grad``, eval mode), the glancing
sampler mixes ground-truth embeddings in at positions chosen by uniform
noise, and pass 2 decodes the mix with gradients. ``decode`` is CIF +
parallel decoder + argmax; the batch decode lives in
:mod:`liteasr_tpu_torch.decode`.

The glance noise comes from the model's CPU ``glance_generator`` (seeded by
:meth:`seed_dropout`) in train mode, and from a fixed stream (seed 0) in
eval mode, as the reference falls back to ``PRNGKey(0)`` when no rng is
given. Both are draws for the dp rank's rows: a stream keyed by the dp
coordinate, or the dp rank's rows of the global batch's draw, which its tp
and sp peers share.

Tensor and sequence parallelism (``parallel.sharding.shard_model``): tp
shards the encoder as U2's and the parallel decoder's attentions and FFNs
as U2's decoder (pass 1 runs K1 at the rank's head offset); the predictor
and the embeddings stay replicated. Under sp the training forward gathers
the encoder's blocks of frames before the predictor, since CIF and its
k = 3 conv read the whole time axis, and runs the predictor, both decoder
passes and the glancing sampler on the rank's block of rows
(:meth:`tail_rows`), with the noise of those rows.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from liteasr_tpu_torch.config import II, MISSING, LiteasrDataclass
from liteasr_tpu_torch.models import LiteasrModel, register_model
from liteasr_tpu_torch.models.u2 import _DTYPES
from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.parallel import rank_seed
from liteasr_tpu_torch.nets.attention import RelativeMultiHeadAttention
from liteasr_tpu_torch.nets.common import Dense, lecun_normal_, positional_encoding
from liteasr_tpu_torch.nets.encoder import TransformerEncoder, subsample_mask
from liteasr_tpu_torch.nets.paraformer import ParallelDecoder, Predictor, glancing_sample
from liteasr_tpu_torch.ops.masks import padding_mask

IGNORE = -1
# the glance generator's seed is the dropout seed XOR this, so that the two
# CPU generators draw independent streams
GLANCE_SEED_SALT = 0x7F4A7C15
# the eval-mode glance stream (the reference's PRNGKey(0) fallback)
EVAL_GLANCE_SEED = 0


@dataclass
class ParaformerConfig(LiteasrDataclass):
    """The reference's schema (liteasr_tpu/models/paraformer.py:25-73), so
    that configs written by either package compose here unchanged."""

    name: Optional[str] = field(default="Paraformer")

    dropout_rate: float = 0.0

    use_rel: bool = True
    input_dim: int = MISSING
    enc_dim: int = 256
    enc_ff_dim: int = 2048
    enc_attn_heads: int = 4
    enc_dropout_rate: float = II("model.dropout_rate")
    enc_pos_dropout_rate: float = II("model.enc_dropout_rate")
    enc_attn_dropout_rate: float = II("model.enc_dropout_rate")
    enc_ff_dropout_rate: float = II("model.enc_dropout_rate")
    enc_layers: int = 12
    activation: str = "swish"

    sample_ratio: float = 0.75
    # anneal sample_ratio -> sample_ratio_end linearly over
    # sample_ratio_decay_steps optimizer steps; None/0 keeps the ratio
    sample_ratio_end: Optional[float] = None
    sample_ratio_decay_steps: int = 0
    # true (the reference): validation mixes ground truth in too; false
    # scores validation with ratio 0
    glance_at_eval: bool = True
    # CIF path: None = the size rule, False = the scan, True = closed form
    dense_cif: Optional[bool] = None

    vocab_size: int = MISSING
    dec_dim: int = 256
    dec_ff_dim: int = 2048
    dec_attn_heads: int = 4
    dec_dropout_rate: float = II("model.dropout_rate")
    dec_self_attn_dropout_rate: float = II("model.dec_dropout_rate")
    dec_src_attn_dropout_rate: float = II("model.dec_dropout_rate")
    dec_ff_dropout_rate: float = II("model.dec_dropout_rate")
    dec_layers: int = 6

    pos_dropout_rate: float = II("model.dec_dropout_rate")

    dtype: str = "float32"


_DROPOUTS = ("enc_dropout_rate", "enc_pos_dropout_rate", "enc_attn_dropout_rate",
             "enc_ff_dropout_rate", "dec_dropout_rate", "dec_self_attn_dropout_rate",
             "dec_src_attn_dropout_rate", "dec_ff_dropout_rate", "pos_dropout_rate")


@register_model("Paraformer", dataclass=ParaformerConfig)
class Paraformer(LiteasrModel):
    def __init__(self, input_dim: int = 80, vocab_size: int = 0, use_rel: bool = True,
                 enc_dim: int = 256, enc_ff_dim: int = 2048, enc_attn_heads: int = 4,
                 enc_layers: int = 12, activation: str = "swish",
                 sample_ratio: float = 0.75, sample_ratio_end: Optional[float] = None,
                 sample_ratio_decay_steps: int = 0, glance_at_eval: bool = True,
                 dense_cif: Optional[bool] = None, dec_dim: int = 256,
                 dec_ff_dim: int = 2048, dec_attn_heads: int = 4, dec_layers: int = 6,
                 enc_dropout_rate: float = 0.0, enc_pos_dropout_rate: float = 0.0,
                 enc_attn_dropout_rate: float = 0.0, enc_ff_dropout_rate: float = 0.0,
                 dec_dropout_rate: float = 0.0, dec_self_attn_dropout_rate: float = 0.0,
                 dec_src_attn_dropout_rate: float = 0.0, dec_ff_dropout_rate: float = 0.0,
                 pos_dropout_rate: float = 0.0, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if enc_dim != dec_dim:
            raise ValueError("the glancing sampler mixes embeddings into CIF vectors: "
                             f"enc_dim {enc_dim} != dec_dim {dec_dim}")
        self.vocab_size = vocab_size
        self.compute_dtype = dtype
        self.sample_ratio = sample_ratio
        self.sample_ratio_end = sample_ratio_end
        self.sample_ratio_decay_steps = sample_ratio_decay_steps
        self.glance_at_eval = glance_at_eval
        self.pos_dropout_rate = pos_dropout_rate
        # parameters are drawn on the CPU, so one seed gives the same
        # weights on every device
        kw = dict(dtype=dtype)
        self.encoder = TransformerEncoder(
            input_dim, use_rel, enc_dim, enc_ff_dim, enc_attn_heads, enc_layers,
            activation, "conformer", dropout_rate=enc_dropout_rate,
            pos_dropout_rate=enc_pos_dropout_rate,
            attn_dropout_rate=enc_attn_dropout_rate,
            ff_dropout_rate=enc_ff_dropout_rate, **kw)
        self.decoder = ParallelDecoder(
            vocab_size, dec_dim, dec_ff_dim, dec_attn_heads, dec_layers,
            dec_dropout_rate, dec_self_attn_dropout_rate, dec_src_attn_dropout_rate,
            dec_ff_dropout_rate, **kw)
        self.embed = nn.Embedding(vocab_size, dec_dim, dtype=torch.float32)
        self.predictor = Predictor(enc_dim, dense_cif, **kw)
        # one CPU generator draws the seeds of every rel-pos attention's
        # in-kernel dropout, another the train-mode glance noise (the other
        # dropouts use the device's generator)
        self.dropout_generator = torch.Generator()
        for module in self.modules():
            if isinstance(module, RelativeMultiHeadAttention):
                module.generator = self.dropout_generator
        self.glance_generator = torch.Generator()
        self.init_params(generator)
        if device is not None:
            self.to(device)

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None):
        """flax's default initializers, drawn from ``generator``: lecun-normal
        kernels (the predictor's conv over its K x I fan-in), zero biases,
        N(0, 1/D) embeddings, xavier-uniform rel-pos biases; norms start at
        identity."""
        for module in self.modules():
            if isinstance(module, (Dense, nn.Conv1d, nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                      generator=generator)
            elif isinstance(module, RelativeMultiHeadAttention):
                module.reset_pos_bias(generator)

    def seed_dropout(self, seed: int, rank: int = 0):
        """Seed the model's own generators: the attention kernels' dropout
        seeds (the same on every ``rank``: each moves to the rank's rows
        where it is used) and, from a salted seed, the glance noise, a
        stream of the rank's own rows (the other dropouts follow
        ``torch.manual_seed``)."""
        self.dropout_generator.manual_seed(seed)
        self.glance_generator.manual_seed(rank_seed(seed ^ GLANCE_SEED_SALT, rank))

    def draw_glance_noise(self, batch: int, length: int, train: bool, device):
        """(B, U) uniform [0, 1) noise of the glancing sampler for the dp
        rank's ``batch`` rows: from ``glance_generator`` in train mode, from
        a fresh generator seeded with EVAL_GLANCE_SEED in eval mode (the same
        draws every call; under a process group, the dp rank's rows of the
        global batch's draw)."""
        if train:
            return torch.rand((batch, length), generator=self.glance_generator).to(device)
        lay = parallel.layout()
        noise = torch.rand((batch * lay.dp, length),
                           generator=torch.Generator().manual_seed(EVAL_GLANCE_SEED))
        return noise[lay.dp_i * batch:(lay.dp_i + 1) * batch].to(device)

    def _glance_ratio(self, train: bool, step=None):
        """The glancing ratio (liteasr_tpu/models/paraformer.py:156-169): 0 at
        eval without ``glance_at_eval``; else ``sample_ratio``, annealed
        linearly to ``sample_ratio_end`` over ``sample_ratio_decay_steps``
        when both are set and ``step`` (optimizer micro-steps taken) is
        given, in fp32 as the reference computes it."""
        if not train and not self.glance_at_eval:
            return 0.0
        ratio = self.sample_ratio
        if (self.sample_ratio_end is not None and self.sample_ratio_decay_steps > 0
                and step is not None):
            frac = torch.clamp(torch.as_tensor(step, dtype=torch.float32)
                               / self.sample_ratio_decay_steps, 0.0, 1.0)
            ratio = ratio + (self.sample_ratio_end - ratio) * frac
        return ratio

    def forward(self, xs, xlens, ys, ylens, train: bool = False, step=None):
        """The two-pass glancing forward (liteasr_tpu/models/paraformer.py:
        171-195). Returns (hs_attn (B, U, V), sum_alpha (B,)), under
        sequence parallelism of the :meth:`tail_rows` only. ``step`` drives
        the glancing-ratio schedule (the trainer's micro-step count before
        this step)."""
        B, T = xs.shape[0], xs.shape[1]
        U = ys.shape[1]
        xs_mask = padding_mask(xlens, T)

        hs_enc = self.encoder(xs, mask=xs_mask, train=train)
        if self.seq_parallel:
            rows = self.tail_rows(B)
            hs_enc = self.gather_frames(hs_enc, subsample_mask(xs_mask).shape[1])[rows]
            xs_mask, xlens, ys, ylens = xs_mask[rows], xlens[rows], ys[rows], ylens[rows]
        ys_in = torch.where(ys == IGNORE, self.eos, ys)
        ys_mask = padding_mask(ylens, U)
        hs_cif, sum_alpha = self.predictor(hs_enc, self.get_pred_len(xlens), ylens,
                                           u_max=U)
        embed_ys = positional_encoding(  # the reference's pe(embed(ys_in))
            F.embedding(ys_in, self.embed.weight.to(self.compute_dtype)),
            self.pos_dropout_rate, train)

        with torch.no_grad():  # pass 1: eval mode on the detached CIF vectors
            hs_hat = self.decoder(hs_cif.detach(), hs_enc.detach(), memory_mask=xs_mask)
            ys_hat = torch.argmax(hs_hat, dim=-1).masked_fill(ys_mask, self.eos)

        # every sp peer draws the dp rank's rows and keeps its own
        noise = self.draw_glance_noise(B, U, train, xs.device)[self.tail_rows(B)]
        hs_mix = glancing_sample(noise, hs_cif, embed_ys, ys_in, ys_hat, ylens,
                                 self._glance_ratio(train, step))
        # pass 2, with gradients
        hs_attn = self.decoder(hs_mix, hs_enc, memory_mask=xs_mask, train=train)
        return hs_attn, sum_alpha

    def decode(self, xs, xlens, u_max: int):
        """CIF (lengths from alpha) + parallel decoder + argmax
        (liteasr_tpu/models/paraformer.py:197-208). Returns (token ids (B,
        u_max), ulens (B,) = clip(round(sum_alpha), 0, u_max))."""
        xs_mask = padding_mask(xlens, xs.shape[1])
        h = self.encoder(xs, mask=xs_mask)
        h_cif, sum_alpha = self.predictor(h, self.get_pred_len(xlens), None, u_max=u_max)
        h_attn = self.decoder(h_cif, h, memory_mask=xs_mask)
        hyp = torch.argmax(h_attn, dim=-1)
        ulens = torch.clamp(torch.round(sum_alpha).long(), 0, u_max)
        return hyp, ulens

    # ---- criterion hooks (liteasr_tpu/models/paraformer.py:212-219) ----

    def get_pred_len(self, xlens):
        return ((xlens - 1) // 2 - 1) // 2

    def get_target(self, ys, ylens):
        return ys

    def get_target_len(self, ylens):
        return ylens

    @classmethod
    def build_model(cls, cfg, task=None, device=None, generator=None):
        """Build from the composed config."""
        if task is not None:
            cfg.input_dim = task.feat_dim
            cfg.vocab_size = task.vocab_size
        dtype = str(cfg.get("dtype", "float32"))
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported model.dtype {dtype!r}")
        end = cfg.get("sample_ratio_end")
        dense = cfg.get("dense_cif")
        return cls(
            input_dim=int(cfg.input_dim),
            vocab_size=int(cfg.vocab_size),
            use_rel=bool(cfg.use_rel),
            enc_dim=int(cfg.enc_dim),
            enc_ff_dim=int(cfg.enc_ff_dim),
            enc_attn_heads=int(cfg.enc_attn_heads),
            enc_layers=int(cfg.enc_layers),
            activation=str(cfg.activation),
            sample_ratio=float(cfg.sample_ratio),
            sample_ratio_end=None if end is None else float(end),
            sample_ratio_decay_steps=int(cfg.get("sample_ratio_decay_steps") or 0),
            glance_at_eval=bool(cfg.get("glance_at_eval", True)),
            dense_cif=None if dense is None else bool(dense),
            dec_dim=int(cfg.dec_dim),
            dec_ff_dim=int(cfg.dec_ff_dim),
            dec_attn_heads=int(cfg.dec_attn_heads),
            dec_layers=int(cfg.dec_layers),
            **{key: float(cfg.get(key, 0.0)) for key in _DROPOUTS},
            dtype=_DTYPES[dtype],
            device=device,
            generator=generator,
        )
