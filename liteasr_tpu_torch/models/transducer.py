"""Transducer (RNN-T) model (liteasr_tpu/models/transducer.py).

Rel-pos transformer encoder, LSTM prediction network and the additive tanh
joint; ``forward`` broadcasts enc (B, T', 1, J) + dec (B, 1, U+1, J) into
the (B, T', U+1, V) lattice. Special ids: blank=0, ignore=-1. Greedy and
beam decoding live in :mod:`liteasr_tpu_torch.decode`.

Tensor and sequence parallelism (``parallel.sharding.shard_model``): tp
shards the encoder as U2's; the prediction network and the joint match no
rule and stay replicated. Under sp the training forward gathers the
encoder's blocks of frames and runs the prediction network and the joint
on the rank's block of rows (:meth:`tail_rows`), so that a rank's lattice
is (B/sp, T', U+1, V).

Spans (``utils.tracing``, on only under a profiler): ``rnnt.predictor``
around the prediction network and ``rnnt.joint`` around the joint, in
:meth:`Transducer.forward`.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from liteasr_tpu_torch.config import II, MISSING, LiteasrDataclass
from liteasr_tpu_torch.models import LiteasrModel, register_model
from liteasr_tpu_torch.models.u2 import _DTYPES
from liteasr_tpu_torch.nets.attention import RelativeMultiHeadAttention
from liteasr_tpu_torch.nets.common import Dense, lecun_normal_
from liteasr_tpu_torch.nets.encoder import TransformerEncoder, subsample_mask
from liteasr_tpu_torch.nets.rnn_decoder import RNNDecoder
from liteasr_tpu_torch.ops.masks import padding_mask
from liteasr_tpu_torch.utils import tracing

IGNORE = -1
BLANK = 0


@dataclass
class TransducerConfig(LiteasrDataclass):
    """The reference's schema (liteasr_tpu/models/transducer.py:27-55), so
    that configs written by either package compose here unchanged."""

    name: Optional[str] = field(default="transducer")

    joint_dim: int = 768
    dropout_rate: float = 0.0

    enc_arch: str = "transformer"
    use_rel: bool = True
    input_dim: int = MISSING
    enc_dim: int = 256
    enc_ff_dim: int = 2048
    enc_attn_heads: int = 4
    enc_dropout_rate: float = II("model.dropout_rate")
    enc_pos_dropout_rate: float = II("model.enc_dropout_rate")
    enc_attn_dropout_rate: float = II("model.enc_dropout_rate")
    enc_ff_dropout_rate: float = II("model.enc_dropout_rate")
    enc_layers: int = 4
    activation: str = "relu"

    dec_arch: str = "lstm"
    vocab_size: int = MISSING
    dec_dim: int = 256
    dec_units: int = 2048
    dec_dropout_rate: float = II("model.dropout_rate")
    dec_layers: int = 2

    dtype: str = "float32"


_DROPOUTS = ("enc_dropout_rate", "enc_pos_dropout_rate", "enc_attn_dropout_rate",
             "enc_ff_dropout_rate", "dec_dropout_rate")


@register_model("transducer", dataclass=TransducerConfig)
class Transducer(LiteasrModel):
    def __init__(self, input_dim: int = 80, vocab_size: int = 0,
                 joint_dim: int = 768, enc_arch: str = "transformer",
                 use_rel: bool = True, enc_dim: int = 256, enc_ff_dim: int = 2048,
                 enc_attn_heads: int = 4, enc_layers: int = 4,
                 activation: str = "relu", dec_dim: int = 256,
                 dec_units: int = 2048, dec_layers: int = 2,
                 enc_dropout_rate: float = 0.0, enc_pos_dropout_rate: float = 0.0,
                 enc_attn_dropout_rate: float = 0.0,
                 enc_ff_dropout_rate: float = 0.0, dec_dropout_rate: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size = vocab_size
        # parameters are drawn on the CPU, so one seed gives the same
        # weights on every device
        kw = dict(dtype=dtype)
        self.encoder = TransformerEncoder(
            input_dim, use_rel, enc_dim, enc_ff_dim, enc_attn_heads, enc_layers,
            activation, enc_arch, dropout_rate=enc_dropout_rate,
            pos_dropout_rate=enc_pos_dropout_rate,
            attn_dropout_rate=enc_attn_dropout_rate,
            ff_dropout_rate=enc_ff_dropout_rate, **kw)
        self.decoder = RNNDecoder(vocab_size, dec_dim, dec_units, dec_layers,
                                  dec_dropout_rate, **kw)
        self.lin_enc = Dense(enc_dim, joint_dim, **kw)
        self.lin_dec = Dense(dec_units, joint_dim, bias=False, **kw)
        self.lin_jnt = Dense(joint_dim, vocab_size, **kw)
        # one CPU generator draws the seeds of every rel-pos attention's
        # in-kernel dropout (the other dropouts use the device's generator)
        self.dropout_generator = torch.Generator()
        for module in self.modules():
            if isinstance(module, RelativeMultiHeadAttention):
                module.generator = self.dropout_generator
        self.init_params(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None):
        """flax's default initializers, drawn from ``generator``: lecun-normal
        kernels, zero biases, xavier-uniform rel-pos biases; the prediction
        network as :meth:`RNNDecoder.reset_parameters` says, its forget-gate
        biases 1 (``Transducer.post_init_params``)."""
        for module in self.modules():
            if isinstance(module, (Dense, nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, RelativeMultiHeadAttention):
                module.reset_pos_bias(generator)
        self.decoder.reset_parameters(generator)

    def seed_dropout(self, seed: int, rank: int = 0):
        """Seed the attention kernels' dropout seeds, the same on every
        ``rank`` (each moves to the rank's rows where it is used; the other
        dropouts follow ``torch.manual_seed``)."""
        self.dropout_generator.manual_seed(seed)

    def joint(self, h_enc, h_dec):
        """tanh(lin_enc(h_enc) + lin_dec(h_dec)) -> vocab logits; the shapes
        broadcast (liteasr_tpu/models/transducer.py:108-111)."""
        return self.lin_jnt(torch.tanh(self.lin_enc(h_enc) + self.lin_dec(h_dec)))

    def forward(self, xs, xlens, ys, ylens, train: bool = False):
        """The joint lattice (B, T', U+1, V): ignore -> blank, a blank column
        prepended to the labels. Under sequence parallelism, of the
        :meth:`tail_rows` only."""
        B = xs.shape[0]
        xs_mask = padding_mask(xlens, xs.shape[1])
        blank_col = torch.full((B, 1), BLANK, dtype=ys.dtype, device=ys.device)
        ys_in = torch.cat([blank_col, torch.where(ys == IGNORE, BLANK, ys)], dim=1)
        h_enc = self.encoder(xs, mask=xs_mask, train=train)  # (B, T', D)
        if self.seq_parallel:
            rows = self.tail_rows(B)
            h_enc = self.gather_frames(h_enc, subsample_mask(xs_mask).shape[1])[rows]
            ys_in = ys_in[rows]
        with tracing.span("rnnt.predictor", xs.device):
            h_dec = self.decoder(ys_in, train=train)  # (B, U+1, H)
        with tracing.span("rnnt.joint", xs.device):
            return self.joint(h_enc[:, :, None, :], h_dec[:, None, :, :])

    def encode(self, xs, xlens):
        """Encoder forward for decoding. Returns (h_enc, enc_mask (B, T'))."""
        xs_mask = padding_mask(xlens, xs.shape[1])
        return self.encoder(xs, mask=xs_mask), subsample_mask(xs_mask)

    def decoder_init_state(self, batch: int, device=None):
        return self.decoder.init_state(batch, device)

    def decoder_step(self, tok, state):
        return self.decoder.step(tok, state)

    # ---- criterion hooks (liteasr_tpu/models/transducer.py:148-155) ----

    def get_pred_len(self, xlens):
        return ((xlens - 1) // 2 - 1) // 2

    def get_target(self, ys, ylens):
        return torch.where(ys == IGNORE, BLANK, ys)

    def get_target_len(self, ylens):
        return ylens

    @classmethod
    def build_model(cls, cfg, task=None, device=None, generator=None):
        """Build from the composed config. The prediction network is an LSTM;
        another ``dec_arch`` raises, as the JAX package has no other."""
        if task is not None:
            cfg.input_dim = task.feat_dim
            cfg.vocab_size = task.vocab_size
        if str(cfg.get("dec_arch", "lstm")) != "lstm":
            raise NotImplementedError(
                f"dec_arch {cfg.dec_arch!r}: the transducer's prediction network is an LSTM")
        dtype = str(cfg.get("dtype", "float32"))
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported model.dtype {dtype!r}")
        return cls(
            input_dim=int(cfg.input_dim),
            vocab_size=int(cfg.vocab_size),
            joint_dim=int(cfg.joint_dim),
            enc_arch=str(cfg.enc_arch),
            use_rel=bool(cfg.use_rel),
            enc_dim=int(cfg.enc_dim),
            enc_ff_dim=int(cfg.enc_ff_dim),
            enc_attn_heads=int(cfg.enc_attn_heads),
            enc_layers=int(cfg.enc_layers),
            activation=str(cfg.activation),
            dec_dim=int(cfg.dec_dim),
            dec_units=int(cfg.dec_units),
            dec_layers=int(cfg.dec_layers),
            **{key: float(cfg.get(key, 0.0)) for key in _DROPOUTS},
            dtype=_DTYPES[dtype],
            device=device,
            generator=generator,
        )
