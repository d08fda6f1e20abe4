"""Training CLI (liteasr_tpu/train.py; reference liteasr/train.py:21-101).

    python -m liteasr_tpu_torch.train task=asr model=my_U2 \\
        criterion=my_hybrid_ctc optimizer=my_noam task.vocab=... \\
        task.train=... task.valid=... postprocess.workflow=[]

Trains on ``cuda:0``; a caller of :func:`train` may pass another device
(the CPU tests do). The composed config is written to
``<run_dir>/config.yaml``, so ``python -m liteasr_tpu_torch.infer
--config-dir <run_dir>`` decodes the checkpoints it saves.

Options the port has not ported raise ``NotImplementedError``, naming the
ROADMAP item that ports them: the multi-device layouts (``distributed.dp``/
``tp``/``sp`` > 1). Streaming models train here too
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

from liteasr_tpu_torch import tasks
from liteasr_tpu_torch.config import compose
from liteasr_tpu_torch.config.core import to_yaml

logger = logging.getLogger("liteasr_tpu_torch.train")

LOG_FORMAT = (
    "[%(asctime)s][%(levelname)s][%(name)s:%(lineno)s][%(funcName)s]"
    " - %(message)s")


def setup_logging(run_dir: str, level: str = "INFO",
                  filename: str = "train.log") -> None:
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


def check_ported(cfg) -> None:
    """Raise on the options the port does not have yet."""
    dist = cfg.distributed
    if any(int(dist.get(a) or 1) > 1 for a in ("dp", "tp", "sp")):
        raise NotImplementedError(
            "distributed.dp/tp/sp > 1: multi-device training is the ROADMAP "
            "item \"DDP\"")


def train(cfg, device: Optional[torch.device] = None):
    """Build everything and run the trainer on ``device`` (default
    ``cuda:0``, which must exist); returns the Trainer.

    ``common.prng_impl`` and ``common.compile_cache_dir`` are JAX settings
    and have no effect here; ``optimization.fused_step`` neither (the port
    has one optimizer path)."""
    from liteasr_tpu_torch.trainer import Trainer

    check_ported(cfg)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device=torch.device('cpu') "
                               "to train on the CPU")
        device = torch.device("cuda", 0)
    device = torch.device(device)

    seed = int(cfg.common.seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # dropout masks draw from the device generator
    logger.info("set random seed as %d", seed)

    task = tasks.setup_task(cfg.task)
    logger.info("setting %s task...", task.__class__.__name__)

    logger.info("1. load data...")
    # common.memory_save: the batchified train set is staged to
    # <train dir>/.dump and read back one batch at a time (one process, so
    # no barrier; liteasr_tpu/train.py:90-111)
    task.load_dataset("train", task.cfg.train, cfg.dataset, cfg.postprocess,
                      memory_save=bool(cfg.common.get("memory_save")))
    task.load_dataset("valid", task.cfg.valid, cfg.dataset, cfg.postprocess)

    generator = torch.Generator().manual_seed(seed)
    model = task.build_model(cfg.model, device=device, generator=generator)
    model.seed_dropout(seed)
    logger.info("2. build model    : %s", model.__class__.__name__)

    optim = task.build_optimizer(cfg.optimizer)
    logger.info("3. build optimizer: %s", optim.__class__.__name__)

    criter = task.build_criterion(cfg.criterion)
    logger.info("4. build criterion: %s", criter.__class__.__name__)

    with open(os.path.join(cfg.common.run_dir, "config.yaml"), "w") as f:
        f.write(to_yaml(cfg))

    trainer = Trainer(cfg, task, model, criter, optim, device)
    trainer.run()
    return trainer


def main(argv: Optional[List[str]] = None,
         device: Optional[torch.device] = None):
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(overrides)
    setup_logging(cfg.common.run_dir, cfg.common.log_level)
    return train(cfg, device)


def cli_main() -> None:
    main()


if __name__ == "__main__":
    cli_main()
