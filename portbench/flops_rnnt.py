"""Operations of the transducer's train step from shapes alone, counted as
:mod:`flops` counts U2's: GEMMs 2 M N K, a train step three times its
forward, elementwise work (the gates, tanh, the log-softmax and the DP)
left out."""

from typing import Iterable, Tuple

import flops


def transducer_forward_flops(frames: int, labels: int, vocab: int, feat_dim: int = 80,
                             enc_layers: int = 12, d: int = 256, ff: int = 2048,
                             conv_k: int = 15, embed: int = 256, units: int = 256,
                             dec_layers: int = 2, joint: int = 512) -> float:
    """Products of one utterance's forward: the conformer encoder (as
    :func:`flops.u2_forward_flops` counts it, without a head or decoder),
    the LSTM layers' input and recurrent products over ``labels + 1``
    positions, the joint's two projections and its projection of the
    T' x (labels + 1) lattice to the vocabulary."""
    t_sub = flops.subsampled(frames)
    u1 = labels + 1
    encoder = flops.u2_forward_flops(frames, labels, 0, feat_dim=feat_dim,
                                     enc_layers=enc_layers, dec_layers=0, d=d, ff=ff,
                                     conv_k=conv_k)
    predictor = sum(2 * u1 * 4 * units * ((embed if i == 0 else units) + units)
                    for i in range(dec_layers))
    lattice = 2 * t_sub * d * joint + 2 * u1 * units * joint + 2 * t_sub * u1 * joint * vocab
    return float(encoder + predictor + lattice)


def transducer_train_flops(rows: Iterable[Tuple[int, int]], vocab: int, **widths) -> float:
    """One train micro-step over utterances of (frames, labels): three
    times the forward of each."""
    return 3.0 * sum(transducer_forward_flops(t, u, vocab, **widths) for t, u in rows)
