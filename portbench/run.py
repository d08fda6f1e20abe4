"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics and the trace's breakdown;
both end with the numbers of the correctness check beside their limits.
The last line of standard output is the run's JSON result. A run needs
the cards its cell asks for: without them it exits with code 2 and
prints no result. ``--control`` plants the lower-precision control or a
fault in place of the program (for calibrating the check's limits and
for the tests); the benchmark's own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402

CONTROLS = ("", "control", "state_unchanged", "half_batch")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS, default="")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_environment()
    try:
        cell = harness.load_cell(args.workload)
        harness.require_cards(cell.chips)
    except harness.SetupError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, bool(args.trace)
    cell.control, cell.t_start = args.control, T_START
    cell.device = torch.device("cuda", 0)
    torch.cuda.set_device(cell.device)
    run = harness.load_module("drivers", cell.traffic["driver"]).run(cell)
    torch.cuda.synchronize()
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: the process holds {', '.join(loaded)}: the benchmark "
              "runs the port alone", file=sys.stderr)
        return 3
    line = harness.result_line(cell, run, harness.device_record(
        cell.chips, run.memory_peak_bytes, run.trace if cell.trace else None))
    harness.print_checks(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
