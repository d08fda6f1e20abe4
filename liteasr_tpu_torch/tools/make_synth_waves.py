"""Synthetic raw-audio corpus for wav2vec 2.0 pretraining evidence.

Each utterance is a sequence of 'phones': short segments of char-specific
sinusoid mixtures (3 partials with per-char frequencies/amplitudes) with
amplitude envelopes, silence gaps, speaker gain and additive noise — enough
temporal structure that contrastive pretraining can beat chance by a wide
margin, unlike white noise.

A copy of tools/make_synth_waves.py that writes through the port's
``data.kaldi_io.write_wav``: the same flags, defaults and draws, so that the
waves and wav.scp are the same bytes.

Usage:
    python -m liteasr_tpu_torch.tools.make_synth_waves --out exp/synth_waves \
        --train-utts 2000 --valid-utts 100 --seed 0
"""

import argparse
import os
from typing import List, Optional

import numpy as np

from liteasr_tpu_torch.data import kaldi_io

RATE = 16000


def build_phone_bank(rng, n=30):
    bank = []
    for _ in range(n):
        freqs = rng.uniform(120, 3200, size=3)
        amps = rng.dirichlet(np.ones(3))
        bank.append((freqs, amps))
    return bank


def render_wave(rng, bank, seconds):
    total = int(seconds * RATE)
    out = np.zeros(total, np.float32)
    pos = 0
    while pos < total:
        freqs, amps = bank[int(rng.integers(len(bank)))]
        dur = int(rng.uniform(0.06, 0.22) * RATE)
        t = np.arange(dur) / RATE
        seg = sum(a * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28))
                  for f, a in zip(freqs, amps))
        env = np.hanning(dur)
        n = min(dur, total - pos)
        out[pos:pos + n] += (seg * env)[:n].astype(np.float32)
        pos += n + int(rng.uniform(0.0, 0.03) * RATE)  # short gap
    gain = 0.25 * (1.0 + 0.2 * rng.normal())
    out = gain * out + 0.01 * rng.normal(size=total).astype(np.float32)
    return np.clip(out, -1.0, 1.0)


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--train-utts", type=int, default=2000)
    ap.add_argument("--valid-utts", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    bank = build_phone_bank(rng)
    for split, n in (("train", args.train_utts), ("valid", args.valid_utts)):
        d = os.path.join(args.out, split)
        os.makedirs(d, exist_ok=True)
        lines = []
        for i in range(n):
            seconds = float(rng.uniform(2.5, 5.0))
            wav = render_wave(rng, bank, seconds)
            path = os.path.join(d, f"u{i:05d}.wav")
            kaldi_io.write_wav(path, wav)
            lines.append(f"{split}_u{i:05d} {os.path.abspath(path)}")
            if (i + 1) % 500 == 0:
                print(f"  {split}: {i + 1}/{n}", flush=True)
        with open(os.path.join(d, "wav.scp"), "w") as f:
            f.write("\n".join(lines) + "\n")
    print("done:", args.out)


if __name__ == "__main__":
    main()
