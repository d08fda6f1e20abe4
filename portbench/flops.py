"""Operations and bytes the benchmark's cells need, from shapes alone, and
the card's published peaks.

The counts do not look at how the program computes: a later kernel that
does the same work reads the same count. GEMMs count 2 M N K; a train
step counts three times its forward (the gradients with respect to the
inputs and to the weights each cost one forward). Elementwise work,
norms and softmax are left out, so a share of the peak is a slight
underestimate.
"""

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

W2V_CONV_LAYERS = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2


def subsampled(t: int) -> int:
    """Frames after the conv2d front end's two stride-2 3x3 convs."""
    return ((t - 1) // 2 - 1) // 2


def u2_forward_flops(frames: int, labels: int, vocab: int, feat_dim: int = 80,
                     enc_layers: int = 12, dec_layers: int = 6, d: int = 256,
                     ff: int = 2048, conv_k: int = 15) -> float:
    """Products of one utterance's forward: the conv2d front end,
    ``enc_layers`` conformer blocks (two macaron FFs, q/k/v/out and the
    rel-pos projection, the conv module, the quadratic attention terms),
    the CTC head, and ``dec_layers`` decoder layers over ``labels + 1``
    positions with the vocab head."""
    t_sub = subsampled(frames)
    u_dec = labels + 1
    t2 = (frames - 1) // 2
    sub = (2 * 9 * t2 * (feat_dim // 2) * d
           + 2 * 9 * t_sub * (feat_dim // 4) * d * d
           + 2 * t_sub * (feat_dim // 4) * d * d)
    enc_frame = (2 * (2 * d * ff * 2) + 2 * d * d * 5
                 + (2 * d * (2 * d) + 2 * d * d + 2 * conv_k * d))
    enc_quad = 3 * 2 * t_sub * t_sub * d
    dec_frame = 2 * (2 * d * d * 4) + 2 * d * ff * 2
    dec_quad = 2 * 2 * u_dec * u_dec * d + 2 * 2 * u_dec * t_sub * d
    encoder = sub + enc_layers * (t_sub * enc_frame + enc_quad)
    decoder = dec_layers * (u_dec * dec_frame + dec_quad) + 2 * u_dec * d * vocab
    return float(encoder + 2 * t_sub * d * vocab + decoder)


def u2_train_flops(rows: Iterable[Tuple[int, int]], vocab: int, **widths) -> float:
    """One train micro-step over utterances of (frames, labels): three
    times the forward of each."""
    return 3.0 * sum(u2_forward_flops(t, u, vocab, **widths) for t, u in rows)


def w2v2_train_flops(rows: int, samples: int, dim: int = 768, layers: int = 12,
                     final_dim: int = 768, groups: int = 2, codes: int = 320) -> float:
    """One wav2vec 2.0 BASE micro-step of ``rows`` crops of ``samples``
    (three times the forward's products): the conv extractor, the conv
    positional embedding (128 taps, 16 groups), the transformer layers
    (projections, FF, both attention products), the input projection,
    the final projection to ``final_dim``, the quantizer's logits over
    ``groups`` x ``codes`` entries, its codebook (``final_dim / groups``
    wide a group) and its projection, and the 101 candidates' dot
    products in ``final_dim``."""
    flops, t, c_in = 0.0, samples, 1
    for width, k, s in W2V_CONV_LAYERS:
        t = (t - k) // s + 1
        flops += 2.0 * rows * t * width * c_in * k
        c_in = width
    n, d = rows * t, dim
    flops += 2.0 * n * d * (d // 16) * 128
    flops += layers * (2.0 * n * 4 * d * d + 2.0 * n * 2 * d * 3072
                       + 2 * 2.0 * rows * t * t * d)
    f, entries = final_dim, groups * codes
    flops += 2.0 * n * (c_in * d + d * f + c_in * entries + entries * (f // groups) + f * f)
    flops += 2.0 * 101 * n * f
    return 3 * flops


# ---- attention kernels' least time (the roofline) ----

def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> Tuple[float, str]:
    """(least seconds, what bounds it): the larger of the operations at
    the peak of the operands' type and the bytes at the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def live_keys(bh: int, tq: int, tk: int, kv_lens: Optional[Sequence[int]]) -> np.ndarray:
    """(BH, Tq) keys each query needs: those below kv_len (capped at Tk);
    all Tk for a row with no key."""
    kv = (np.full(bh, tk, np.int64) if kv_lens is None
          else np.minimum(np.asarray(kv_lens, np.int64), tk))
    end = np.broadcast_to(kv[:, None], (bh, tq))
    return np.where(kv[:, None] > 0, end, tk)


def fwd_bound(bh: int, tq: int, tk: int, d: int, kv_lens=None, rel: bool = True,
              lse: bool = False, heads: int = 1, itemsize: int = 2,
              mask_bytes: int = 0) -> float:
    """Least seconds of one K1/K1' call: Q K^T, P V and the rel-pos
    Q_v P^T over the live scores; each input read once and each output
    written once (K and V up to each row's last live key). ``heads`` is
    the rel-pos table's rows (it is shared over the batch)."""
    live = live_keys(bh, tq, tk, kv_lens)
    keys = float(live.max(axis=1).sum())
    flops = (3 if rel else 2) * 2.0 * float(live.sum()) * d
    q_bytes = bh * tq * d * itemsize * (2 if rel else 1)
    p_bytes = heads * tk * d * itemsize if rel else 0
    kv_bytes = 2 * keys * d * itemsize
    out = bh * tq * d * itemsize + (4 * bh * tq if lse else 0)
    lens = 4 * bh if kv_lens is not None else 0
    return bound_s(flops, q_bytes + p_bytes + kv_bytes + out + lens + mask_bytes)[0]


def bwd_bound(bh: int, t: int, d: int, kv_lens=None, heads: int = 1,
              itemsize: int = 2) -> float:
    """Least seconds of one K2 call: eight products over the live scores
    x D, the inputs (q_u, q_v, k, v, p, kv_lens, out, lse, dout) read once,
    the five fp32 gradients written once."""
    flops = 8 * 2.0 * float(live_keys(bh, t, t, kv_lens).sum()) * d
    act = bh * t * d
    inputs = (6 * act + heads * t * d) * itemsize + 4 * bh * t + (4 * bh if kv_lens is not None else 0)
    grads = 4 * (4 * act + heads * t * d)
    return bound_s(flops, inputs + grads)[0]
