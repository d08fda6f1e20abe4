"""Batch inference + scoring CLI (liteasr_tpu/infer.py; reference
liteasr/infer.py:25-129).

Usage: ``python -m liteasr_tpu_torch.infer --config-dir <run_dir>
[overrides]``, where run_dir holds the resolved ``config.yaml`` of a
training run. The test set is decoded in length-sorted batches on one
``torch.device``: a U2 by ``inference.mode`` (default ``attention_rescore``;
``streaming_ctc_greedy`` and ``streaming_ctc_prefix_beam_search`` run the
chunk-by-chunk runtime of :mod:`liteasr_tpu_torch.streaming` with
``inference.chunk_sub`` frames a chunk, default 16), a transducer greedily
(``mode=transducer_greedy``) or else by the beam search with
``inference.expansions_per_frame``, a Paraformer by CIF + argmax (whatever
the mode),
with the checkpoint, or the average of checkpoints, that
``checkpoint.load_ckpt`` picks; raw-wave test sets (``dataset.fbank``) get
their log-mel features on the device. Checkpoints are in the one-process
layout whatever the training run's (dp, sp, tp), and under a process group
of any layout every rank decodes the full model on its block of each
batch's rows (:func:`infer_dataset`), as the JAX package replicates the
tree (liteasr_tpu/infer.py:50-56).
"""

import logging
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from liteasr_tpu_torch import decode, parallel, tasks
from liteasr_tpu_torch.checkpoint import load_ckpt
from liteasr_tpu_torch.config import compose
from liteasr_tpu_torch.config.core import load_yaml
from liteasr_tpu_torch.data.dataset import dummy_min_xlen
from liteasr_tpu_torch.ops.fbank import log_mel_fbank
from liteasr_tpu_torch.streaming import streaming_decode
from liteasr_tpu_torch.utils.misc import round_up
from liteasr_tpu_torch.utils.score import levenshtein

logger = logging.getLogger("liteasr_tpu_torch.infer")

LOG_FORMAT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"


def setup_logging(run_dir: str, level: str = "INFO",
                  filename: str = "infer.log") -> None:
    os.makedirs(run_dir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper()))
    for h in list(root.handlers):
        root.removeHandler(h)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter("[%(levelname)s]: %(message)s"))
    root.addHandler(console)
    fileh = logging.FileHandler(os.path.join(run_dir, filename))
    fileh.setFormatter(logging.Formatter(LOG_FORMAT))
    root.addHandler(fileh)


def infer_dataset(task, model, dataset, infer_cfg, device: torch.device,
                  pad_time_multiple: int = 128, verbose: bool = True,
                  collect=None):
    """Decode one test set on ``device``; returns (total_err, total_len).

    ``model`` must already live on ``device``. ``collect``: optional list
    that receives ``(ref, hyp)`` text pairs in decode order (length-sorted).

    Under a process group of W ranks (liteasr_tpu/infer.py:41-84) each
    batch's rows are padded to a multiple of W with dummy rows (zeros of
    ``dummy_min_xlen`` frames), each rank decodes its block of rows, and the
    hypotheses are gathered to every rank, so that every rank returns the
    same error count and ``collect``. Every rank must call it.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if next(model.parameters()).device != device:
        raise ValueError(f"the model is not on {device}")
    fbank = bool(getattr(dataset, "fbank", False))

    batch_size = int(infer_cfg.get("batch_size", 8))
    beam_size = int(infer_cfg.get("beam_size", 10))
    ctc_weight = float(infer_cfg.get("ctc_weight", 0.5))
    expansions = int(infer_cfg.get("expansions_per_frame", 5))
    mode = str(infer_cfg.get("mode", "attention_rescore"))

    world, rank = parallel.process_count(), parallel.process_index()
    data = sorted(dataset.data, key=lambda a: a.xlen, reverse=True)
    total_err, total_len = 0, 0
    for lo in range(0, len(data), batch_size):
        chunk = data[lo:lo + batch_size]
        rows = round_up(len(chunk), world)
        T = round_up(max(a.xlen for a in chunk), pad_time_multiple)
        xs = np.zeros((rows, T) if fbank else (rows, T, dataset.feat_dim), np.float32)
        xlens = np.full(rows, min(dummy_min_xlen(fbank), T), np.int64)
        for i, a in enumerate(chunk):
            xs[i, : a.xlen] = a.x
            xlens[i] = a.xlen
        mine = slice(rank * rows // world, (rank + 1) * rows // world)
        xs = torch.from_numpy(xs[mine]).to(device)
        xlens = torch.from_numpy(xlens[mine]).to(device)
        if fbank:  # raw waves (samples) -> log-mel features on the device
            xs, xlens = log_mel_fbank(xs, xlens, num_mel_bins=dataset.num_mel_bins)
        if hasattr(model, "joint"):  # the transducer family
            if mode == "transducer_greedy":
                hyps = decode.transducer_greedy(model, xs, xlens.long())
            else:  # the beam search is the reference's default
                hyps = decode.transducer_beam_search(
                    model, xs, xlens.long(), beam_size=beam_size,
                    expansions_per_frame=expansions)
        elif hasattr(model, "predictor"):  # Paraformer: CIF + argmax
            hyps = decode.paraformer_decode(model, xs, xlens.long())
        elif mode.startswith("streaming"):  # streaming_ctc_greedy | ..._prefix_beam_search
            hyps = streaming_decode(
                model, xs, xlens, chunk_sub=int(infer_cfg.get("chunk_sub", 16)),
                mode="ctc_prefix_beam_search" if "prefix" in mode else "ctc_greedy",
                beam_size=beam_size)
        else:
            hyps = decode.decode_batch(model, xs, xlens.long(), beam_size=beam_size,
                                       ctc_weight=ctc_weight, mode=mode)
        if world > 1:  # every rank's block, in row order
            hyps = [h for block in parallel.all_gather_object(
                [[int(t) for t in h] for h in hyps]) for h in block]
        for a, hyp_ids in zip(chunk, hyps):
            hyp = task.ids_to_text(hyp_ids)
            ref = task.normalize_ref(a.text)
            if collect is not None:
                collect.append((ref, hyp))
            err = levenshtein(ref, hyp)
            total_err += err
            total_len += len(ref)
            res = "[X]" if ref == hyp else "[ ]"
            log = logger.info if verbose else logger.debug
            log("\n%s %s\n%3d %s", res, hyp, err, ref)
    return total_err, total_len


def infer(cfg, device: Optional[torch.device] = None):
    """Decode every test set of the composed config; returns
    [(errors, ref length), ...]. ``device`` defaults to the first GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device=torch.device('cpu') "
                               "to decode on the CPU")
        device = torch.device("cuda", 0)
    task = tasks.setup_task(cfg.task)
    logger.info("setting %s task...", task.__class__.__name__)

    logger.info("1. load data...")
    task.load_dataset("test", list(task.cfg.test), cfg.dataset, None)

    model = task.build_model(cfg.model)
    model.load_state_dict(load_ckpt(cfg.inference))
    model.to(device).eval()

    results = []
    dump = cfg.inference.get("dump")
    for si, test_set in enumerate(task.dataset("test")):
        pairs = [] if dump else None
        err, length = infer_dataset(
            task, model, test_set, cfg.inference, device,
            pad_time_multiple=cfg.dataset.get("pad_time_multiple", 128),
            collect=pairs)
        results.append((err, length))
        logger.info("Error rate: %d / %d = %.2f%%",
                    err, length, 100.0 * err / max(length, 1))
        if dump:
            path = str(dump) if si == 0 else f"{dump}.{si}"
            with open(path, "w") as f:
                for i, (ref, hyp) in enumerate(pairs):
                    f.write(f"{i}\t{ref}\t{hyp}\n")
            logger.info("dumped %d ref/hyp pairs to %s", len(pairs), path)
    return results


def main(argv: Optional[List[str]] = None):
    args = list(argv if argv is not None else sys.argv[1:])
    config_dir = None
    if "--config-dir" in args:
        i = args.index("--config-dir")
        config_dir = args[i + 1]
        del args[i:i + 2]
    base = None
    if config_dir:
        base = load_yaml(os.path.join(config_dir, "config.yaml"))
    cfg = compose(args, base=base)
    setup_logging(cfg.common.run_dir, cfg.common.log_level,
                  filename="infer.log")
    return infer(cfg)


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
