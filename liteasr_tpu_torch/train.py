"""Training CLI (liteasr_tpu/train.py; reference liteasr/train.py:21-101).

    python -m liteasr_tpu_torch.train task=asr model=my_U2 \\
        criterion=my_hybrid_ctc optimizer=my_noam task.vocab=... \\
        task.train=... task.valid=... postprocess.workflow=[]

Trains on ``cuda:0``; ``--device cpu`` (or a caller of :func:`train`
passing a device, as the CPU tests do) trains elsewhere. The composed config
is written to ``<run_dir>/config.yaml``, so ``python -m
liteasr_tpu_torch.infer --config-dir <run_dir>`` decodes the checkpoints it
saves.

Data parallelism: start one process per device with the JAX CLI's fields,

    python -m liteasr_tpu_torch.train ... \
        distributed.coordinator_address=127.0.0.1:29500 \
        distributed.num_processes=N distributed.process_id=R

Rank R trains on ``cuda:<R % device count>`` in an NCCL process group (gloo
with ``--device cpu``) on its row block of the global batch, which the
criterions, BatchNorm and the optimizer reduce over the group
(``liteasr_tpu_torch.parallel``). ``distributed.dp`` must be -1 or N. The
master alone writes ``train.log``, the results rows, the checkpoints and
``config.yaml``; the other ranks log to the console.

Tensor and sequence parallelism: ``distributed.tp=T distributed.sp=S`` (and
``distributed.dp=-1`` or N / (S T)) lay the N processes out as the JAX
package's (dp, sp, tp) mesh, tp innermost (``parallel.mesh.Layout``), for
every family: tp shards the encoder's and the decoders' attentions, FFNs
and conv modules Megatron's way and must divide the heads and the widths
(the transducer's LSTM and joint, the Paraformer's CIF predictor and
wav2vec 2.0's extractor, quantizer and positional conv stay whole); sp
splits the encoder's frames and runs each family's tail on the rank's rows
(wav2vec 2.0: the extractor on the rank's sample window and the logits on
its frames; ``parallel.sharding``). Checkpoints and the train state are
written in the one-process layout. Streaming models train here too
(``model.enc_arch=transformer model.dynamic_chunk=true`` or
``model.static_chunk_size=N``), and so do the transducer
(``model=my_transducer criterion=my_rnnt``) and the Paraformer
(``model=Paraformer criterion=paraformer_loss``).
"""

import logging
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from liteasr_tpu_torch import parallel, tasks
from liteasr_tpu_torch.parallel import sharding
from liteasr_tpu_torch.config import compose
from liteasr_tpu_torch.config.core import to_yaml

logger = logging.getLogger("liteasr_tpu_torch.train")

LOG_FORMAT = (
    "[%(asctime)s][%(levelname)s][%(name)s:%(lineno)s][%(funcName)s]"
    " - %(message)s")


def setup_logging(run_dir: str, level: str = "INFO",
                  filename: Optional[str] = "train.log") -> None:
    """The console, and ``<run_dir>/<filename>`` unless ``filename`` is None
    (a rank other than the master)."""
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper()))
    for h in list(root.handlers):
        root.removeHandler(h)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter("[%(levelname)s]: %(message)s"))
    root.addHandler(console)
    if filename is None:
        return
    os.makedirs(run_dir, exist_ok=True)
    fileh = logging.FileHandler(os.path.join(run_dir, filename))
    fileh.setFormatter(logging.Formatter(LOG_FORMAT))
    root.addHandler(fileh)


def train(cfg, device: Optional[torch.device] = None,
          deadline: Optional[float] = None):
    """Join the process group that ``distributed.*`` names (if any), then
    build everything and run the trainer on ``device`` (default
    ``cuda:<process_id % device count>``, which must exist) until
    ``deadline`` (a ``time.time()`` value; the Trainer's); returns the
    Trainer. A group started here ends here, after a barrier. Layouts the
    port does not have raise first (``parallel.mesh.check_layout``).

    ``common.prng_impl`` and ``common.compile_cache_dir`` are JAX settings
    and have no effect here; ``optimization.fused_step`` neither (the port
    has one optimizer path)."""
    device = parallel.distributed_init(cfg.distributed, device)  # before the device is used
    if not cfg.distributed.get("coordinator_address"):
        return _train(cfg, device, deadline)
    try:
        trainer = _train(cfg, device, deadline)
        parallel.barrier()  # no rank leaves while another still needs it
    finally:
        parallel.destroy()
    return trainer


def _train(cfg, device: torch.device, deadline: Optional[float] = None):
    from liteasr_tpu_torch.trainer import Trainer

    seed, lay = int(cfg.common.seed), parallel.layout()
    # the host's draws are per-row streams: the dp rank's own (dp rank 0
    # keeps the run's; tp and sp peers hold the same rows); so are the
    # device's, once the model's init has drawn the same weights on every
    # rank: keyed by (dp_i, sp_i), so that the activations a tp group holds
    # whole are dropped alike
    np.random.seed(parallel.rank_seed(seed, lay.dp_i))
    torch.manual_seed(seed)  # dropout masks draw from the device generator
    parallel.seed_streams(seed)
    logger.info("set random seed as %d", seed)

    task = tasks.setup_task(cfg.task)
    logger.info("setting %s task...", task.__class__.__name__)

    logger.info("1. load data...")
    # common.memory_save: the batchified train set is staged to
    # <train dir>/.dump and read back one batch at a time; the master builds
    # the dump while the others wait on a barrier, then they read it
    # (liteasr_tpu/train.py:90-111)
    config = (cfg.dataset, cfg.postprocess)
    if cfg.common.get("memory_save") and parallel.process_count() > 1:
        if parallel.is_master():
            task.load_dataset("train", task.cfg.train, *config, memory_save=True)
        parallel.barrier()
        if not parallel.is_master():
            task.load_dataset("train", task.cfg.train, *config, memory_save=True)
    else:
        task.load_dataset("train", task.cfg.train, *config,
                          memory_save=bool(cfg.common.get("memory_save")))
    task.load_dataset("valid", task.cfg.valid, *config)

    generator = torch.Generator().manual_seed(seed)
    model = task.build_model(cfg.model, device=device, generator=generator)
    model.seed_dropout(seed, lay.dp_i)
    sharding.shard_model(model, lay, cfg.model)
    activations = lay.dp_i * lay.sp + lay.sp_i
    if activations:
        torch.manual_seed(parallel.rank_seed(seed, activations))
    logger.info("2. build model    : %s", model.__class__.__name__)

    optim = task.build_optimizer(cfg.optimizer)
    logger.info("3. build optimizer: %s", optim.__class__.__name__)

    criter = task.build_criterion(cfg.criterion)
    logger.info("4. build criterion: %s", criter.__class__.__name__)

    if parallel.is_master():
        os.makedirs(cfg.common.run_dir, exist_ok=True)
        with open(os.path.join(cfg.common.run_dir, "config.yaml"), "w") as f:
            f.write(to_yaml(cfg))

    trainer = Trainer(cfg, task, model, criter, optim, device, deadline)
    trainer.run()
    return trainer


def main(argv: Optional[List[str]] = None,
         device: Optional[torch.device] = None, deadline: Optional[float] = None):
    """``argv``: config overrides, and ``--device DEVICE`` (e.g. ``cpu``)
    where ``device`` is not given; ``deadline``: :func:`train`'s."""
    overrides = list(argv if argv is not None else sys.argv[1:])
    if "--device" in overrides:
        i = overrides.index("--device")
        device = device if device is not None else torch.device(overrides[i + 1])
        del overrides[i:i + 2]
    cfg = compose(overrides)
    master = int(cfg.distributed.get("process_id") or 0) == 0
    setup_logging(cfg.common.run_dir, cfg.common.log_level,
                  filename="train.log" if master else None)
    return train(cfg, device, deadline)


def cli_main() -> None:
    main()


if __name__ == "__main__":
    cli_main()
