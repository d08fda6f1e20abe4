"""The benchmark's one traffic generator. A mix is a data file,
``traffic/<mix>.json``; this module turns it and a seed into utterances.

Every seed gets the same set of sizes, in another order: the durations
are the quantiles (i + 1/2) / N of the mix's clipped log-normal, so two
seeds batch into the same shapes and differ in which utterances share a
batch, in the order the batches come and in every value drawn (features,
labels, weights). The features are 80-dim standard-normal frames (the
scale of mean- and variance-normalized log-mel features), cut from one
pool drawn from the seed.
"""

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np


@dataclass
class Utterance:
    """What the port's collator reads of an utterance (``x``, ``xlen``,
    ``y``, ``ylen``), in memory."""

    __slots__ = ("x", "xlen", "y", "ylen")
    x: np.ndarray
    xlen: int
    y: np.ndarray
    ylen: int


def durations(spec: Dict, n: int) -> np.ndarray:
    """Seconds of ``n`` utterances: the quantiles of the log-normal with
    ``median`` and ``sigma``, clipped to [``min``, ``max``]."""
    inv = NormalDist().inv_cdf
    z = np.array([inv((i + 0.5) / n) for i in range(n)])
    secs = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(secs, spec["min"], spec["max"])


def utterances(mix: Dict, seed: int, feat_dim: int, vocab: int) -> List[Utterance]:
    """The mix's utterances for ``seed``: durations assigned in a seeded
    order, frames at ``frame_shift_s``, ``labels_per_s`` label ids drawn
    from [1, vocab - 2] (0 is the blank, vocab - 1 sos/eos)."""
    rng = np.random.default_rng(seed)
    n = int(mix["utterances"])
    secs = durations(mix["seconds"], n)[rng.permutation(n)]
    frames = np.maximum(np.round(secs / mix["frame_shift_s"]).astype(np.int64), 1)
    labels = np.maximum(np.round(secs * mix["labels_per_s"]).astype(np.int64), 1)
    pool_frames = int(frames.max()) + int(mix.get("pool_frames", 200_000))
    pool = rng.standard_normal((pool_frames, feat_dim), dtype=np.float32)
    starts = rng.integers(0, pool_frames - frames + 1)
    out = []
    for t, u, s in zip(frames.tolist(), labels.tolist(), starts.tolist()):
        y = rng.integers(1, vocab - 1, size=u).astype(np.int32)
        out.append(Utterance(pool[s:s + t], t, y, u))
    return out


def waves(mix: Dict, seed: int) -> List[Utterance]:
    """The mix's raw 16 kHz waves for ``seed``: durations assigned in a
    seeded order, each wave a view of one pool of standard-normal samples
    whose loudness changes every second (log10 of the amplitude uniform in
    ``amplitude_log10``)."""
    rng = np.random.default_rng(seed)
    n, rate = int(mix["utterances"]), int(mix["sample_rate"])
    secs = durations(mix["seconds"], n)[rng.permutation(n)]
    samples = np.maximum(np.round(secs * rate).astype(np.int64), 1)
    pool_len = int(samples.max()) + int(mix.get("pool_seconds", 120)) * rate
    lo, hi = mix["amplitude_log10"]
    loud = 10.0 ** rng.uniform(lo, hi, size=-(-pool_len // rate)).astype(np.float32)
    pool = rng.standard_normal(pool_len, dtype=np.float32) * np.repeat(loud, rate)[:pool_len]
    starts = rng.integers(0, pool_len - samples + 1)
    empty = np.zeros(0, np.int32)
    return [Utterance(pool[s:s + t], t, empty, 0) for t, s in zip(samples.tolist(),
                                                                  starts.tolist())]


def audio_seconds(frames: int, mix: Dict) -> float:
    """Seconds of ``frames`` feature frames, or of samples for a wave mix."""
    if "sample_rate" in mix:
        return frames / mix["sample_rate"]
    return frames * mix["frame_shift_s"]
