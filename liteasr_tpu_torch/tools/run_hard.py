"""Hard-corpus convergence runs: tools/run_hard.sh as a Python entry point.

The BPE-unit corpus (``make_synth_corpus --hard``: 248 units, 10 tight
confusable pairs, noise 0.55) targets a 2-10% token error regime, so that
decode-mode and checkpoint-averaging comparisons have statistical power
(``score_ci``).

    python -m liteasr_tpu_torch.tools.run_hard u2|transducer|paraformer \\
        [run_dir] [epochs] [overrides...] [--device cpu]

The overrides are run_hard.sh's (the family's model and criterion, my_noam,
the corpus, bf16, accum 2; the Paraformer's glancing schedule and honest
eval), then the caller's, as ``"$@"`` follows them there: a convergence run
adds ``common.resume=auto common.results_file=<path>``.
``common.compile_cache_dir`` is passed as run_hard.sh passes it, and the
port ignores it (a JAX compile setting). ``train.main`` runs in this
process, on ``cuda:0`` unless ``--device`` (or ``device=``) names another.
The corpus is rendered first where ``<repo>/exp/synth_hard`` (or
``corpus=``) holds none: at make_synth_corpus's defaults, 20,000 / 500 / 500
utterances from seed 0. ``run(..., timeout_s=S)`` is run_hard.sh's
``LITEASR_HARD_TIMEOUT_S``: no epoch starts after S seconds of wall clock.
The run stops at the first epoch boundary past them, after that epoch's
valid pass and save, so its last save is whole and resumable.
"""

import os
import sys
import time
from typing import List, Optional, Sequence

from liteasr_tpu_torch.tools import make_synth_corpus

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(REPO, "exp", "synth_hard")
CORPUS_UTTS = (20000, 500, 500)  # train, valid, test: the generator's defaults

# tools/run_hard.sh:19-28
FAMILIES = {
    "u2": ["model=my_U2", "criterion=my_hybrid_ctc"],
    "transducer": ["model=my_transducer", "criterion=my_rnnt"],
    # the glancing schedule and honest eval are part of the recipe: without
    # them pure-CIF decode degenerates; anneal 0.75 -> 0.1 so the decoder
    # must learn to read CIF vectors alone
    "paraformer": ["model=Paraformer", "criterion=paraformer_loss",
                   "model.sample_ratio_end=0.1",
                   "model.sample_ratio_decay_steps=4000",
                   "model.glance_at_eval=false"],
}


def default_run_dir(family: str) -> str:
    return os.path.join(REPO, "exp", f"hard_{family}_run")


def overrides(family: str, run_dir: str, epochs: int = 10,
              extra: Sequence[str] = (), corpus: str = CORPUS) -> List[str]:
    """train.main's overrides for ``family`` (tools/run_hard.sh:34-42),
    ``extra`` last."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}: one of {sorted(FAMILIES)}")
    return [
        "task=asr", *FAMILIES[family], "optimizer=my_noam",
        f"task.vocab={corpus}/vocab.txt", 'task.delimiter=" "',
        f"task.train={corpus}/train", f"task.valid={corpus}/valid",
        f"task.test=[{corpus}/test]",
        f"task.save_dir={run_dir}/ckpts", f"common.run_dir={run_dir}",
        f"common.compile_cache_dir={REPO}/exp/.jax_cache",
        "model.dtype=bfloat16",
        f"optimization.max_epoch={epochs}", "optimization.accum_grad=2",
        *extra]


def ensure_corpus(corpus: str = CORPUS, utts: Sequence[int] = CORPUS_UTTS) -> bool:
    """Render the ``--hard`` corpus (seed 0) into ``corpus`` unless its last
    file (the test split's utt2num_frames) is there; True if it rendered."""
    if os.path.isfile(os.path.join(corpus, "test", "utt2num_frames")):
        return False
    train, valid, test = utts
    make_synth_corpus.main([
        "--out", corpus, "--hard", "--seed", "0",
        "--train-utts", str(train), "--valid-utts", str(valid),
        "--test-utts", str(test)])
    return True


def run(family: str = "u2", run_dir: Optional[str] = None, epochs: int = 10,
        extra: Sequence[str] = (), *, corpus: str = CORPUS,
        corpus_utts: Sequence[int] = CORPUS_UTTS,
        timeout_s: Optional[float] = None, device=None):
    """Render the corpus if it is missing, then train, starting no epoch
    after ``timeout_s`` seconds; returns the Trainer."""
    from liteasr_tpu_torch import train

    deadline = time.time() + timeout_s if timeout_s else None
    run_dir = os.path.abspath(run_dir or default_run_dir(family))
    args = overrides(family, run_dir, epochs, extra, corpus)
    ensure_corpus(corpus, corpus_utts)
    os.makedirs(run_dir, exist_ok=True)
    return train.main(args, device=device, deadline=deadline)


def main(argv: Optional[List[str]] = None):
    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = torch.device(args[i + 1])
        del args[i:i + 2]
    family = args[0] if args else "u2"
    run_dir = args[1] if len(args) > 1 else None
    epochs = int(args[2]) if len(args) > 2 else 10
    return run(family, run_dir, epochs, args[3:], device=device)


if __name__ == "__main__":
    main()
