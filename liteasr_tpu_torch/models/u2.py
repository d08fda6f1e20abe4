"""U2: hybrid CTC/attention Conformer ASR model (liteasr_tpu/models/u2.py).
Special ids: blank=0, sos=eos=V-1, ignore=-1.

``forward(..., train=True)`` is the training forward, with every dropout of
the reference and BatchNorm on batch statistics; ``remat=True`` recomputes
the encoder layers in the backward pass. ``static_chunk_size`` and
``dynamic_chunk`` make the encoder's attention chunked (streaming models);
``encode_chunk`` is one step of the streaming runtime
(:mod:`liteasr_tpu_torch.streaming`). Decoding lives in
:mod:`liteasr_tpu_torch.decode`.

Tensor and sequence parallelism (``parallel.sharding.shard_model``): under
sp the encoder returns the rank's block of frames, which the training
forward gathers over the sp group (with autograd) before the CTC head and
the decoder; the tail then runs on the rank's block of rows
(:meth:`tail_rows`), so the sp group splits it instead of repeating it.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from liteasr_tpu_torch.config import II, MISSING, LiteasrDataclass
from liteasr_tpu_torch.models import LiteasrModel, register_model
from liteasr_tpu_torch.nets.attention import RelativeMultiHeadAttention
from liteasr_tpu_torch.nets.common import Dense, dropout, lecun_normal_
from liteasr_tpu_torch.nets.decoder import TransformerDecoder
from liteasr_tpu_torch.nets.encoder import TransformerEncoder, subsample_mask
from liteasr_tpu_torch.ops.masks import padding_mask, triangle_mask

IGNORE = -1
# the chunk generator's seed is the dropout seed XOR this, so that the two
# CPU generators draw independent streams (JAX splits "chunk" from "dropout")
CHUNK_SEED_SALT = 0x9E3779B9


@dataclass
class U2Config(LiteasrDataclass):
    """The reference's schema (liteasr_tpu/models/u2.py:28-76), so that
    configs written by either package compose here unchanged."""

    name: Optional[str] = field(default="U2")

    dropout_rate: float = 0.0

    enc_arch: str = "conformer"  # transformer | conformer
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
    static_chunk_size: int = 0
    dynamic_chunk: bool = False
    remat: bool = False
    normalize_before: bool = True

    dec_arch: str = "transformer"
    vocab_size: int = MISSING
    dec_dim: int = 256
    dec_ff_dim: int = 2048
    dec_attn_heads: int = 4
    dec_dropout_rate: float = II("model.dropout_rate")
    dec_pos_dropout_rate: float = II("model.dec_dropout_rate")
    dec_self_attn_dropout_rate: float = II("model.dec_dropout_rate")
    dec_src_attn_dropout_rate: float = II("model.dec_dropout_rate")
    dec_ff_dropout_rate: float = II("model.dec_dropout_rate")
    dec_layers: int = 6

    dtype: str = "float32"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


_DROPOUTS = ("dropout_rate", "enc_dropout_rate", "enc_pos_dropout_rate",
             "enc_attn_dropout_rate", "enc_ff_dropout_rate", "dec_dropout_rate",
             "dec_pos_dropout_rate", "dec_self_attn_dropout_rate",
             "dec_src_attn_dropout_rate", "dec_ff_dropout_rate")


@register_model("U2", dataclass=U2Config)
class U2(LiteasrModel):
    def __init__(self, input_dim: int = 80, vocab_size: int = 0,
                 enc_arch: str = "conformer", use_rel: bool = True,
                 enc_dim: int = 256, enc_ff_dim: int = 2048,
                 enc_attn_heads: int = 4, enc_layers: int = 12,
                 activation: str = "swish", normalize_before: bool = True,
                 dec_dim: int = 256, dec_ff_dim: int = 2048,
                 dec_attn_heads: int = 4, dec_layers: int = 6,
                 dropout_rate: float = 0.0, enc_dropout_rate: float = 0.0,
                 enc_pos_dropout_rate: float = 0.0,
                 enc_attn_dropout_rate: float = 0.0,
                 enc_ff_dropout_rate: float = 0.0,
                 dec_dropout_rate: float = 0.0,
                 dec_pos_dropout_rate: float = 0.0,
                 dec_self_attn_dropout_rate: float = 0.0,
                 dec_src_attn_dropout_rate: float = 0.0,
                 dec_ff_dropout_rate: float = 0.0, remat: bool = False,
                 static_chunk_size: int = 0, dynamic_chunk: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if enc_dim != dec_dim:
            raise ValueError("the decoder attends to the encoder output: "
                             f"enc_dim {enc_dim} != dec_dim {dec_dim}")
        self.vocab_size = vocab_size
        self.dropout_rate = dropout_rate
        # parameters are drawn on the CPU, so one seed gives the same
        # weights on every device
        kw = dict(dtype=dtype)
        self.encoder = TransformerEncoder(
            input_dim, use_rel, enc_dim, enc_ff_dim, enc_attn_heads,
            enc_layers, activation, enc_arch,
            normalize_before=normalize_before, dropout_rate=enc_dropout_rate,
            pos_dropout_rate=enc_pos_dropout_rate,
            attn_dropout_rate=enc_attn_dropout_rate,
            ff_dropout_rate=enc_ff_dropout_rate, remat=remat,
            static_chunk_size=static_chunk_size, dynamic_chunk=dynamic_chunk, **kw)
        self.decoder = TransformerDecoder(
            vocab_size, dec_dim, dec_ff_dim, dec_attn_heads, dec_layers,
            normalize_before, dec_dropout_rate, dec_pos_dropout_rate,
            dec_self_attn_dropout_rate, dec_src_attn_dropout_rate,
            dec_ff_dropout_rate, **kw)
        self.ctc_lo = Dense(enc_dim, vocab_size, **kw)
        # one CPU generator draws the seeds of every rel-pos attention's
        # in-kernel dropout (the other dropouts use the device's generator)
        self.dropout_generator = torch.Generator()
        for module in self.modules():
            if isinstance(module, RelativeMultiHeadAttention):
                module.generator = self.dropout_generator
        # draws the dynamic chunk widths (the JAX package's "chunk" rng)
        self.chunk_generator = self.encoder.chunk_generator
        self.init_params(generator)
        if device is not None:
            self.to(device)

    @property
    def sos(self) -> int:
        return self.vocab_size - 1

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None):
        """flax's default initializers, drawn from ``generator``: lecun-normal
        kernels, zero biases, N(0, 1/D) embeddings, xavier-uniform rel-pos
        biases; norms start at identity."""
        for module in self.modules():
            if isinstance(module, (Dense, nn.Conv1d, nn.Conv2d)):
                w = module.weight
                fan_in = w[0].numel()
                lecun_normal_(w, fan_in, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                      generator=generator)
            elif isinstance(module, RelativeMultiHeadAttention):
                module.reset_pos_bias(generator)

    def seed_dropout(self, seed: int, rank: int = 0):
        """Seed the model's own generators: the attention kernels' dropout
        seeds and, from a salted seed, the dynamic chunk widths (the other
        dropouts follow ``torch.manual_seed``). Both are the same on every
        ``rank``: a kernel seed moves to the rank's rows where it is used,
        and the width is one draw for the global batch, as in JAX."""
        self.dropout_generator.manual_seed(seed)
        self.chunk_generator.manual_seed(seed ^ CHUNK_SEED_SALT)

    def encode(self, xs, xlens):
        """Encoder forward for decoding. Returns (h_enc, enc_mask (B, T'))."""
        xs_mask = padding_mask(xlens, xs.shape[1])
        return self.encoder(xs, mask=xs_mask), subsample_mask(xs_mask)

    def ctc_logits(self, h_enc):
        return self.ctc_lo(h_enc)

    def encode_chunk(self, window, caches, index: int, kv_lens, pe_len: int):
        """One streaming encoder step (liteasr_tpu/models/u2.py:186-192):
        raw conv window -> (chunk hidden states, CTC logits); the K/V
        ``caches`` are written in place (see ``TransformerEncoder.
        forward_chunk``)."""
        h = self.encoder.forward_chunk(window, caches, index, kv_lens, pe_len)
        return h, self.ctc_lo(h)

    def decode_logits(self, ys_in, h_enc, mask=None, enc_mask=None):
        """Decoder forward over already-subsampled memory."""
        return self.decoder(ys_in, h_enc, mask=mask, memory_mask=enc_mask,
                            memory_mask_presubsampled=True)

    def decode_prime(self, h_enc):
        """Every decoder layer's source K/V, projected once for the cached
        beam search (liteasr_tpu/models/u2.py:200-202)."""
        return self.decoder.prime(h_enc)

    def decode_step(self, tok, src_kv, self_caches, index: int, enc_mask=None):
        """One KV-cached decoder step: ``tok`` (B,) at position ``index``;
        ``enc_mask`` (B, T') True = padding. Returns logits (B, V)."""
        mem_mask = enc_mask[:, None, None, :] if enc_mask is not None else None
        return self.decoder.step(tok, src_kv, self_caches, index, mem_mask)

    def forward(self, xs, xlens, ys, ylens, train: bool = False):
        """Training forward: (h_attn (B, L+1, V), h_ctc (B, T', V))
        (liteasr_tpu/models/u2.py:149-173): ignore -> eos, sos prepended,
        pad | causal decoder mask, CTC head on the dropped encoder output.
        Under sequence parallelism both are of the :meth:`tail_rows`: the
        encoder's blocks of frames are gathered, and the rank runs the
        CTC head and the decoder on its block of rows."""
        xs_mask = padding_mask(xlens, xs.shape[1])
        h_enc = self.encoder(xs, mask=xs_mask, train=train)
        if self.seq_parallel:
            rows = self.tail_rows(xs.shape[0])
            h_enc = self.gather_frames(h_enc, subsample_mask(xs_mask).shape[1])
            h_enc, xs_mask, ys, ylens = h_enc[rows], xs_mask[rows], ys[rows], ylens[rows]
        B, L = ys.shape
        ys_ = torch.where(ys == IGNORE, self.eos, ys)
        sos_col = torch.full((B, 1), self.sos, dtype=ys.dtype, device=ys.device)
        ys_in = torch.cat([sos_col, ys_], dim=1)
        ys_mask = padding_mask(ylens + 1, L + 1)
        causal = triangle_mask(L + 1, device=ys.device)
        h_attn = self.decoder(ys_in, h_enc, mask=ys_mask[:, None, :] | causal[None],
                              memory_mask=xs_mask, train=train)
        return h_attn, self.ctc_lo(dropout(h_enc, self.dropout_rate, train))

    # ---- criterion hooks (liteasr_tpu/models/u2.py:213-225) ----

    def get_pred_len(self, xlens):
        return ((xlens - 1) // 2 - 1) // 2

    def get_target(self, ys, ylens):
        """(attention target (B, L+1): ys with eos at ylen and ignore after,
        CTC target: ys)."""
        B = ys.shape[0]
        ignore_col = torch.full((B, 1), IGNORE, dtype=ys.dtype, device=ys.device)
        tgt_attn = torch.cat([ys, ignore_col], dim=1)
        tgt_attn[torch.arange(B, device=ys.device), ylens.long()] = self.eos
        return tgt_attn, ys

    @classmethod
    def build_model(cls, cfg, task=None, device=None, generator=None):
        """Build from the composed config."""
        if task is not None:
            cfg.input_dim = task.feat_dim
            cfg.vocab_size = task.vocab_size
        if str(cfg.get("dec_arch", "transformer")) != "transformer":
            raise NotImplementedError(f"dec_arch {cfg.dec_arch!r} is not ported")
        dtype = str(cfg.get("dtype", "float32"))
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported model.dtype {dtype!r}")
        return cls(
            input_dim=int(cfg.input_dim),
            vocab_size=int(cfg.vocab_size),
            enc_arch=str(cfg.enc_arch),
            use_rel=bool(cfg.use_rel),
            enc_dim=int(cfg.enc_dim),
            enc_ff_dim=int(cfg.enc_ff_dim),
            enc_attn_heads=int(cfg.enc_attn_heads),
            enc_layers=int(cfg.enc_layers),
            activation=str(cfg.activation),
            normalize_before=bool(cfg.get("normalize_before", True)),
            dec_dim=int(cfg.dec_dim),
            dec_ff_dim=int(cfg.dec_ff_dim),
            dec_attn_heads=int(cfg.dec_attn_heads),
            dec_layers=int(cfg.dec_layers),
            **{key: float(cfg.get(key, 0.0)) for key in _DROPOUTS},
            remat=bool(cfg.get("remat", False)),
            static_chunk_size=int(cfg.get("static_chunk_size", 0)),
            dynamic_chunk=bool(cfg.get("dynamic_chunk", False)),
            dtype=_DTYPES[dtype],
            device=device,
            generator=generator,
        )
