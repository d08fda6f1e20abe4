"""Summarize a training run's train.log into a loss-curve table.

Usage: python -m liteasr_tpu_torch.tools.summarize_run exp/hard_u2_run/train.log [--every 4]
Prints a markdown table of (epoch, iters, valid loss) plus throughput stats.
A copy of tools/summarize_run.py: the port's trainer writes the same
``valid loss:``, ``current loss: ... (N utts/s)`` and ``test error rate:``
lines as the JAX package's.
"""

import argparse
import re
import sys
from typing import List, Optional

VALID_RE = re.compile(
    r"(\d+) / \S+ iters, (\d+) / \S+ epochs - valid loss: ([-\d.a-zA-Z]+)")
THR_RE = re.compile(r"current loss: [-\d.a-zA-Z]+ \(([\d.]+) utts/s\)")
ERR_RE = re.compile(r"test error rate: (\d+) / (\d+) = ([\d.]+)%")


def parse(log: str):
    """(valids, throughputs, errors): ``[(epoch, iters, valid loss)]``, the
    utt/s of every report window, ``[(errors, ref tokens, percent)]``."""
    valids, thrs, errs = [], [], []
    with open(log) as f:
        for line in f:
            m = VALID_RE.search(line)
            if m:
                valids.append((int(m.group(2)), int(m.group(1)),
                               float(m.group(3))))
            m = THR_RE.search(line)
            if m:
                thrs.append(float(m.group(1)))
            m = ERR_RE.search(line)
            if m:
                errs.append((int(m.group(1)), int(m.group(2)),
                             float(m.group(3))))
    return valids, thrs, errs


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--every", type=int, default=4)
    args = ap.parse_args(argv)

    valids, thrs, errs = parse(args.log)
    print("| epoch | optimizer iters | valid loss |")
    print("|---|---|---|")
    for i, (ep, it, vl) in enumerate(valids):
        if i % args.every == 0 or i == len(valids) - 1:
            print(f"| {ep} | {it} | {vl:.2f} |")
    if thrs:
        steady = sorted(thrs)[len(thrs) // 2:]
        print(f"\nmedian-upper-half throughput: "
              f"{sum(steady) / len(steady):.1f} utt/s "
              f"({len(thrs)} report windows)", file=sys.stderr)
    for e, n, pct in errs[-3:]:
        print(f"test error rate: {e}/{n} = {pct:.2f}%", file=sys.stderr)
    return valids, thrs, errs


if __name__ == "__main__":
    main()
