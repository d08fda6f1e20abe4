"""Statistical eval on the hard corpus: tools/eval_hard.sh, eval_hard_td.sh,
eval_hard_pf.sh and eval_streaming.sh as one entry point.

    python -m liteasr_tpu_torch.tools.eval_hard u2|transducer|paraformer|streaming \\
        <run_dir> <epoch> [avg_num] [--device cpu]

Decodes the run's test set (``--config-dir <run_dir>``, checkpoint
``<epoch>``, 32 utterances a batch) under the family's decode-mode and
checkpoint-averaging variants through ``infer.infer``, dumps the ref/hyp
pairs to ``<run_dir>/eval_ep<epoch>/<name>.tsv`` (``eval_stream_ep<epoch>``
for streaming) and scores them with ``score_ci``, single and paired:

- u2: the ``avg_num``-average in attention_rescore and ctc_greedy and the
  last checkpoint in attention_rescore; rows: the averaged rescore, rescore
  vs greedy, averaged vs last;
- transducer: the average by the beam (8) and greedily and the last
  checkpoint by the beam; rows: the averaged beam, beam vs greedy, averaged
  vs last;
- paraformer: CIF + argmax of the average and of the last checkpoint;
  rows: the average, averaged vs last;
- streaming (a dynamic-chunk U2): the average offline in ctc_greedy and
  chunk by chunk in streaming_ctc_greedy at chunk_sub 16 and 8; rows:
  offline, offline vs 16, offline vs 8, 16 vs 8.

Each CI row is appended to ``results`` (default: the run's
``common.results_file``, else ``<out>/score_ci.jsonl``). Every decode pads
its batch's frames to a multiple of 512, as the JAX scripts'
``dataset.pad_time_multiple=512`` does. There it pinned every batch to one
compiled TPU shape; it is kept here because the padding is not inert: the
conformer's rel-pos table has the batch's padded length, and the legacy
rel_shift indexes it from its end, so the padded length moves the encoder
output of the valid frames, in the JAX package as in the port. At 512 the
port decodes the geometry of the JAX package's recorded evals.
"""

import os
import sys
import time
from typing import Dict, List, Optional

from liteasr_tpu_torch.tools import score_ci


def decodes(family: str, avg: int) -> List[tuple]:
    """(name, overrides) of each decode of ``family``, in the scripts' order."""
    average = ["inference.model_avg=true", f"inference.avg_num={avg}"]
    last = ["inference.model_avg=false"]
    table = {
        "u2": [("avg_rescore", average + ["inference.mode=attention_rescore"]),
               ("avg_ctc_greedy", average + ["inference.mode=ctc_greedy"]),
               ("last_rescore", last + ["inference.mode=attention_rescore"])],
        "transducer": [("avg_beam", average + ["inference.beam_size=8"]),
                       ("avg_greedy", average + ["inference.mode=transducer_greedy"]),
                       ("last_beam", last + ["inference.beam_size=8"])],
        "paraformer": [("avg_cif", average), ("last_cif", last)],
        "streaming": [("offline_greedy", average + ["inference.mode=ctc_greedy"]),
                      ("stream_c16", average + ["inference.mode=streaming_ctc_greedy",
                                                "inference.chunk_sub=16"]),
                      ("stream_c8", average + ["inference.mode=streaming_ctc_greedy",
                                               "inference.chunk_sub=8"])],
    }
    if family not in table:
        raise ValueError(f"unknown family {family!r}: one of {sorted(table)}")
    return table[family]


# tools/eval_hard.sh:20-24 (and the other three scripts): the padded length
# reaches the encoder through the legacy rel-pos table, so it is kept
PAD_TIME_MULTIPLE = 512

# the score_ci calls of each script: (dump, paired dump or None)
SCORES = {
    "u2": [("avg_rescore", None), ("avg_rescore", "avg_ctc_greedy"),
           ("avg_rescore", "last_rescore")],
    "transducer": [("avg_beam", None), ("avg_beam", "avg_greedy"),
                   ("avg_beam", "last_beam")],
    "paraformer": [("avg_cif", None), ("avg_cif", "last_cif")],
    "streaming": [("offline_greedy", None), ("offline_greedy", "stream_c16"),
                  ("offline_greedy", "stream_c8"), ("stream_c16", "stream_c8")],
}


def decode(run_dir: str, epoch: int, name: str, overrides, out: str, *,
           device=None, pad: int = PAD_TIME_MULTIPLE) -> Dict:
    """One decode of the run's test set at checkpoint ``epoch`` with
    ``overrides``, its batches padded to a multiple of ``pad`` frames, dumped
    to ``<out>/<name>.tsv``; returns ``{"errors", "ref_tokens", "seconds"}``."""
    import torch

    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    os.makedirs(out, exist_ok=True)
    print(f"=== {name} ===", flush=True)
    cfg = compose([f"inference.ckpt_name={epoch}", f"dataset.pad_time_multiple={pad}",
                   "inference.batch_size=32", f"inference.dump={out}/{name}.tsv",
                   *overrides],
                  base=load_yaml(os.path.join(run_dir, "config.yaml")))
    infer.setup_logging(cfg.common.run_dir, cfg.common.log_level, filename="infer.log")
    t0 = time.perf_counter()
    (errors, length), = infer.infer(cfg, device=device)
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"{name}: {errors} / {length} = {100.0 * errors / max(length, 1):.2f}% "
          f"in {secs:.2f} s", flush=True)
    return {"errors": int(errors), "ref_tokens": int(length), "seconds": secs}


def evaluate(family: str, run_dir: str, epoch: int, avg: int = 5, *,
             device=None, results: Optional[str] = None) -> Dict:
    """Decode and score; returns ``{"decodes": {name: {"errors", "ref_tokens",
    "seconds"}}, "rows": [score_ci rows]}``."""
    from liteasr_tpu_torch.config.core import load_yaml

    run_dir = os.path.abspath(run_dir)
    plan = decodes(family, avg)
    base = load_yaml(os.path.join(run_dir, "config.yaml"))
    out = os.path.join(run_dir, f"{'eval_stream' if family == 'streaming' else 'eval'}_ep{epoch}")
    results = results or base.get("common", {}).get("results_file") \
        or os.path.join(out, "score_ci.jsonl")
    report = {"decodes": {}, "rows": []}
    for name, overrides in plan:
        report["decodes"][name] = decode(run_dir, epoch, name, overrides, out,
                                         device=device)
    print("=== CIs ===", flush=True)
    for a, b in SCORES[family]:
        report["rows"].append(score_ci.score(
            f"{out}/{a}.tsv", f"{out}/{b}.tsv" if b else None, json_out=results))
    return report


def main(argv: Optional[List[str]] = None):
    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = torch.device(args[i + 1])
        del args[i:i + 2]
    if len(args) < 3:
        raise SystemExit("usage: eval_hard u2|transducer|paraformer|streaming "
                         "<run_dir> <epoch> [avg_num]")
    family, run_dir, epoch = args[0], args[1], int(args[2])
    avg = int(args[3]) if len(args) > 3 else 5
    return evaluate(family, run_dir, epoch, avg, device=device)


if __name__ == "__main__":
    main()
