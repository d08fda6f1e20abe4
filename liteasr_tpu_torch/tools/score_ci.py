"""Token error rate with bootstrap confidence intervals.

Input: ref/hyp dump files written by ``liteasr_tpu_torch.infer`` with
``inference.dump=<path>`` (TSV: ``index\\tref\\thyp``).

Single system:
    python -m liteasr_tpu_torch.tools.score_ci dump.tsv [--delimiter ' ']
Paired comparison (same test set, same decode order):
    python -m liteasr_tpu_torch.tools.score_ci dumpA.tsv --vs dumpB.tsv

Error rate = sum(edit distance) / sum(ref tokens), resampling UTTERANCES
(the unit of independence) B times for a percentile 95% interval. The
paired comparison bootstraps the rate DIFFERENCE on common indices and
reports the two-sided sign p-value. The same draws as tools/score_ci.py
(``default_rng(0)`` for each rate, ``default_rng(1)`` for the difference),
so both print the same numbers for the same dumps.
"""

import argparse
import json
import time
from typing import List, Optional

import numpy as np

from liteasr_tpu_torch.utils.score import levenshtein


def load(path, delimiter):
    refs, hyps = [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 3:
                continue
            _, ref, hyp = parts
            if delimiter is None:
                refs.append(list(ref))
                hyps.append(list(hyp))
            else:
                # drop empty fields: a rendered ``<space>`` unit becomes a
                # bare " " which splits into empties on both sides
                refs.append([t for t in ref.split(delimiter) if t])
                hyps.append([t for t in hyp.split(delimiter) if t])
    return refs, hyps


def per_utt(refs, hyps):
    # tokens as integer ids (the native Levenshtein takes strings or ints);
    # a one-to-one relabeling leaves every edit distance as it was
    ids = {}

    def encode(tokens):
        return [ids.setdefault(t, len(ids)) for t in tokens]

    errs = np.array([levenshtein(encode(r), encode(h)) for r, h in zip(refs, hyps)],
                    float)
    lens = np.array([max(len(r), 1) for r in refs], float)
    return errs, lens


def bootstrap_rate(errs, lens, B=10000, seed=0):
    rng = np.random.default_rng(seed)
    n = len(errs)
    idx = rng.integers(0, n, size=(B, n))
    rates = errs[idx].sum(axis=1) / lens[idx].sum(axis=1)
    return np.percentile(rates, [2.5, 97.5])


def score(dump: str, vs: Optional[str] = None, delimiter: Optional[str] = " ",
          boot: int = 10000, json_out: Optional[str] = None) -> dict:
    """Print the rate and CI of ``dump`` (and, with ``vs``, the paired
    difference); return the row that ``json_out`` gets appended."""
    refs, hyps = load(dump, delimiter)
    errs, lens = per_utt(refs, hyps)
    rate = errs.sum() / lens.sum()
    lo, hi = bootstrap_rate(errs, lens, boot)
    print(f"{dump}: {100*rate:.2f}% token error "
          f"[{100*lo:.2f}, {100*hi:.2f}] 95% CI  "
          f"({int(errs.sum())} / {int(lens.sum())} over {len(errs)} utts)")
    row = {"kind": "score_ci", "dump": dump, "n_utts": len(errs),
           "rate": round(float(rate), 6),
           "ci95": [round(float(lo), 6), round(float(hi), 6)]}

    if vs:
        refs2, hyps2 = load(vs, delimiter)
        if len(refs2) != len(refs):
            raise ValueError("paired dumps must align")
        if refs[:50] != refs2[:50]:
            raise ValueError("paired dumps must share references/order")
        errs2, lens2 = per_utt(refs2, hyps2)
        rate2 = errs2.sum() / lens2.sum()
        lo2, hi2 = bootstrap_rate(errs2, lens2, boot)
        print(f"{vs}: {100*rate2:.2f}% token error "
              f"[{100*lo2:.2f}, {100*hi2:.2f}] 95% CI")
        rng = np.random.default_rng(1)
        n = len(errs)
        idx = rng.integers(0, n, size=(boot, n))
        d = (errs[idx].sum(axis=1) - errs2[idx].sum(axis=1)) \
            / lens[idx].sum(axis=1)
        dlo, dhi = np.percentile(d, [2.5, 97.5])
        p = min(1.0, 2 * min((d <= 0).mean(), (d >= 0).mean()))
        print(f"paired diff (A-B): {100*(rate-rate2):+.2f}pp "
              f"[{100*dlo:+.2f}, {100*dhi:+.2f}] 95% CI, "
              f"two-sided p≈{max(p, 1/boot):.4f}")
        row.update({
            "vs": vs, "vs_rate": round(float(rate2), 6),
            "vs_ci95": [round(float(lo2), 6), round(float(hi2), 6)],
            "diff": round(float(rate - rate2), 6),
            "diff_ci95": [round(float(dlo), 6), round(float(dhi), 6)],
            "p_two_sided": round(float(max(p, 1 / boot)), 6)})

    if json_out:
        with open(json_out, "a") as f:
            f.write(json.dumps({"ts": round(time.time(), 1), **row}) + "\n")
    return row


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("dump")
    ap.add_argument("--vs", default=None,
                    help="second dump for a paired comparison")
    ap.add_argument("--delimiter", default=" ",
                    help="token delimiter; 'none' for char-level")
    ap.add_argument("--boot", type=int, default=10000)
    ap.add_argument("--json-out", default=None,
                    help="append the scored numbers as one JSONL row")
    args = ap.parse_args(argv)
    delim = None if args.delimiter == "none" else args.delimiter
    return score(args.dump, args.vs, delim, args.boot, args.json_out)


if __name__ == "__main__":
    main()
