"""Synthetic phone-like ASR corpus generator (Kaldi format).

Purpose: a convergence-at-scale proof of the flagship U2 conformer recipe.
The corpus is generated from a seed; its generative process is hard enough
that WER is meaningful: the mapping characters -> acoustics has

* per-character prototype *trajectories* (3 anchor vectors interpolated over
  a random duration), not single static templates, so the model must align;
* duration jitter (Poisson) — no fixed frames-per-token;
* coarticulation — a moving-average smoother blends adjacent characters;
* confusable character pairs — several prototypes are deliberately close,
  so the acoustics alone leave residual ambiguity (non-zero error floor);
* speaker/channel effects — per-utterance gain, a smooth additive channel
  vector, and white noise;
* a word lexicon with Zipf-ish usage — gives the attention decoder LM-like
  structure to exploit (rescoring should beat pure CTC).

Output layout per split (reference manifest format, liteasr/dataclass/
sheet.py): feats.ark + feats.scp + utt2num_frames + text, plus vocab.txt at
the corpus root (char-level tokens, delimiter=None).

A copy of tools/make_synth_corpus.py that writes through the port's
``data.kaldi_helpers``: the same flags and defaults, and one
``np.random.default_rng(seed)`` consumed in the same order, so that the
Kaldi files are the same bytes.

Usage:
    python -m liteasr_tpu_torch.tools.make_synth_corpus --out exp/synth_hard \
        --train-utts 20000 --valid-utts 500 --test-utts 500 --seed 0 --hard
"""

import argparse
import os
from typing import List, Optional

import numpy as np

from liteasr_tpu_torch.data import kaldi_helpers

FEAT_DIM = 80
ALPHABET = "abcdefghijklmnopqrstuvwxyz"
SPACE = "<space>"


def _smooth_vector(rng, dim, scale=1.0):
    """A random vector with smooth structure across mel-like bins."""
    v = rng.normal(size=dim)
    k = np.hanning(9)
    k /= k.sum()
    v = np.convolve(v, k, mode="same")
    return scale * v / max(np.std(v), 1e-6)


def build_phone_inventory(rng, n_confusable_pairs=6):
    """3 anchor vectors per symbol; some pairs made deliberately close."""
    symbols = list(ALPHABET) + [SPACE]
    anchors = {
        s: np.stack([_smooth_vector(rng, FEAT_DIM, scale=1.6)
                     for _ in range(3)])
        for s in symbols
    }
    # space is quiet: compress toward zero
    anchors[SPACE] *= 0.25
    # confusable pairs: b's anchors = a's + small perturbation
    letters = list(ALPHABET)
    rng.shuffle(letters)
    pairs = [(letters[2 * i], letters[2 * i + 1])
             for i in range(n_confusable_pairs)]
    for a, b in pairs:
        anchors[b] = anchors[a] + 0.35 * np.stack(
            [_smooth_vector(rng, FEAT_DIM) for _ in range(3)])
    return anchors, pairs


def build_lexicon(rng, n_words=500):
    words = set()
    while len(words) < n_words:
        length = min(2 + rng.poisson(2.4), 9)
        words.add("".join(rng.choice(list(ALPHABET), size=length)))
    words = sorted(words)
    # Zipf-ish usage frequencies
    freq = 1.0 / np.arange(1, len(words) + 1) ** 0.9
    rng.shuffle(freq)
    return words, freq / freq.sum()


def _apply_merge(seq, a, b):
    out, i = [], 0
    while i < len(seq):
        if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return tuple(out)


def build_bpe_units(words, freqs, n_merges=220):
    """Frequency-weighted BPE over the closed lexicon: multi-char subword
    units (a larger, BPE-like token inventory so quality numbers have
    statistical power). Returns (unit list, word -> units)."""
    from collections import Counter

    seg = {w: tuple(w) for w in words}
    weight = dict(zip(words, freqs))
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, seq in seg.items():
            f = weight[w]
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += f
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append(a + b)
        seg = {w: _apply_merge(s, a, b) for w, s in seg.items()}
    units = sorted(set(ALPHABET) | set(merges))
    return units, seg


def render_utterance(rng, sentence_words, anchors, noise_sigma=0.35,
                     dur_base=3, dur_rate=3.0, coart=(0.2, 0.6, 0.2),
                     channel_scale=0.4):
    """Render a word sequence into (frames, FEAT_DIM) features."""
    symbols = []
    for i, w in enumerate(sentence_words):
        if i > 0:
            symbols.append(SPACE)
        symbols.extend(w)

    chunks = []
    for s in symbols:
        dur = dur_base + rng.poisson(dur_rate)
        a = anchors[s]
        # piecewise-linear trajectory through the 3 anchors
        t = np.linspace(0.0, 2.0, dur)
        lo = np.clip(t.astype(int), 0, 1)
        frac = (t - lo)[:, None]
        chunks.append((1 - frac) * a[lo] + frac * a[lo + 1])
    sil = 0.1 * rng.normal(size=(int(rng.integers(4, 12)), FEAT_DIM))
    frames = np.concatenate([sil, *chunks,
                             0.1 * rng.normal(size=(int(rng.integers(4, 12)),
                                                    FEAT_DIM))])

    # coarticulation: moving average over time
    k = np.asarray(coart, float)
    frames = np.apply_along_axis(
        lambda col: np.convolve(col, k, mode="same"), 0, frames)

    # speaker/channel effects + noise
    gain = 1.0 + 0.12 * rng.normal()
    channel = _smooth_vector(rng, FEAT_DIM, scale=channel_scale)
    frames = gain * frames + channel + noise_sigma * rng.normal(
        size=frames.shape)
    return frames.astype(np.float32)


def make_split(root, name, n_utt, rng, anchors, words, word_p, writer_mod,
               noise_sigma=0.35, seg=None, render_kwargs=None):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    texts, frames_lines = [], []
    ark = os.path.join(d, "feats.ark")
    scp = os.path.join(d, "feats.scp")
    render_kwargs = render_kwargs or {}
    with writer_mod.WriteHelper(f"ark,scp:{ark},{scp}") as w:
        for i in range(n_utt):
            uttid = f"{name}_{i:06d}"
            max_w = 14 if seg is not None else 10
            lam = 4.5 if seg is not None else 3.5
            n_words = int(np.clip(2 + rng.poisson(lam), 2, max_w))
            sent = list(rng.choice(words, size=n_words, p=word_p))
            feats = render_utterance(rng, sent, anchors, noise_sigma,
                                     **render_kwargs)
            w(uttid, feats)
            if seg is not None:
                # BPE-unit labels (task.delimiter=' '): units within a word,
                # an explicit <space> unit between words
                units = []
                for k, wd in enumerate(sent):
                    if k > 0:
                        units.append(SPACE)
                    units.extend(seg[wd])
                texts.append(f"{uttid} {' '.join(units)}")
            else:
                # char-level path (task.delimiter=None) reads a single
                # concatenated token stream: words are separated by silence
                # in the acoustics but not in the labels (sheet.py TextSheet)
                texts.append(f"{uttid} {''.join(sent)}")
            frames_lines.append(f"{uttid} {feats.shape[0]}")
            if (i + 1) % 2000 == 0:
                print(f"  {name}: {i + 1}/{n_utt}", flush=True)
    with open(os.path.join(d, "text"), "w") as f:
        f.write("\n".join(texts) + "\n")
    with open(os.path.join(d, "utt2num_frames"), "w") as f:
        f.write("\n".join(frames_lines) + "\n")


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--train-utts", type=int, default=20000)
    ap.add_argument("--valid-utts", type=int, default=500)
    ap.add_argument("--test-utts", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-sigma", type=float, default=0.35)
    ap.add_argument("--hard", action="store_true",
                    help="the hard regime: BPE-like multi-char units, "
                         "bigger lexicon, 10 tighter confusable pairs, "
                         "shorter/noisier acoustics (target 2-10%% error)")
    ap.add_argument("--bpe-merges", type=int, default=220)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)

    if args.hard:
        anchors, confusable = build_phone_inventory(
            rng, n_confusable_pairs=10)
        for a, b in confusable:  # tighter than the default 0.35
            anchors[b] = anchors[a] + 0.8 * (anchors[b] - anchors[a])
        words, word_p = build_lexicon(rng, n_words=800)
        units, seg = build_bpe_units(words, word_p, args.bpe_merges)
        noise = max(args.noise_sigma, 0.55)
        render_kwargs = dict(dur_base=2, dur_rate=2.5,
                             coart=(0.25, 0.5, 0.25), channel_scale=0.6)
        tokens = ["<unk>"] + units + [SPACE]
    else:
        anchors, confusable = build_phone_inventory(rng)
        words, word_p = build_lexicon(rng)
        seg = None
        noise = args.noise_sigma
        render_kwargs = None
        tokens = ["<unk>"] + list(ALPHABET) + [SPACE]
    print(f"confusable pairs: {confusable}")
    print(f"vocab: {len(tokens)} tokens")

    # vocab ids from 1; <blank>=0 and <sos/eos>=V-1 are added by Vocab
    with open(os.path.join(args.out, "vocab.txt"), "w") as f:
        f.write("".join(f"{t} {i + 1}\n" for i, t in enumerate(tokens)))

    for name, n in (("train", args.train_utts), ("valid", args.valid_utts),
                    ("test", args.test_utts)):
        print(f"rendering {name} ({n} utts)...", flush=True)
        make_split(args.out, name, n, rng, anchors, words, word_p,
                   kaldi_helpers, noise_sigma=noise, seg=seg,
                   render_kwargs=render_kwargs)
    print("done:", args.out)


if __name__ == "__main__":
    main()
