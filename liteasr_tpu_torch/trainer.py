"""Trainer: the train step on one ``torch.device`` and the host event loop
(liteasr_tpu/trainer.py; reference liteasr/trainer.py:28-227).

One micro-step is the criterion's forward (dropout on, BatchNorm on batch
statistics), ``backward`` and :class:`optims.fused_step.FusedAdam`'s update,
which accumulates ``accum_grad`` micro-steps, clips the mean gradient's
global norm and skips a non-finite step. As in the reference, BatchNorm's
running statistics move on every micro-step, a skipped one included
(liteasr_tpu/trainer.py:268-272). The trigger events ``report_loss``,
``valid``, ``save_model`` and ``inference`` run on the host between steps.
"""

import hashlib
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from liteasr_tpu_torch.checkpoint import CKPT_TEMPLATE
from liteasr_tpu_torch.data.loader import EpochDataLoader
from liteasr_tpu_torch.optims.fused_step import build_tx
from liteasr_tpu_torch.utils.trigger import EventManager

logger = logging.getLogger(__name__)


def to_device(batch, device):
    """numpy batch dict -> tensors on ``device`` (ids as int64)."""
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.asarray(val))
        if key in ("ys", "xlens", "ylens"):
            t = t.long()
        out[key] = t.to(device, non_blocking=True)
    return out


class Trainer:
    def __init__(self, cfg, task, model, criterion, optimizer,
                 device: torch.device):
        self.cfg = cfg
        self.task = task
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.iter = 0
        self._loss_accum = []
        self._report_time = time.time()
        self._report_utts = 0

        self.train_iter = EpochDataLoader(
            task.dataset("train"), shuffle=True, seed=cfg.common.seed,
            prefetch=2, num_workers=max(1, cfg.dataset.get("num_workers", 2)))
        self.valid_set = task.dataset("valid")

        self.params = [p for p in model.parameters() if p.requires_grad]
        n_params = sum(p.numel() for p in self.params)
        logger.info("model parameters: %.2fM", n_params / 1e6)
        self.tx = build_tx(optimizer, cfg.optimization, self.params)
        self._emit_run_meta(n_params)
        self._add_events()

    # ------------------------------------------------------------- step

    def train_step(self, batch) -> torch.Tensor:
        """One micro-step on a device batch; returns the detached loss."""
        loss, _ = self.criterion(self.model, batch, train=True)
        loss.backward()
        self.tx.update([p.grad for p in self.params])
        for p in self.params:
            p.grad = None
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch):
        loss, aux = self.criterion(self.model, batch, train=False)
        return loss, aux

    # ------------------------------------------------------------- events

    def _add_events(self):
        self.event_manager = EventManager()
        for t in self.cfg.common.trigger:
            if not hasattr(self, t["name"]):
                raise ValueError(f"unknown trigger event {t['name']!r}")
            self.event_manager.register(
                getattr(self, t["name"]), t["interval"], t["unit"])
        self.event_manager.align(self.iter, self.epoch)

    @property
    def epoch(self):
        return self.train_iter.epoch

    @property
    def max_epoch(self):
        me = self.cfg.optimization.max_epoch
        return me if me > 0 else "inf"

    @property
    def max_iter(self):
        mi = self.cfg.optimization.max_iter
        return mi if mi > 0 else "inf"

    def stop(self) -> bool:
        opt = self.cfg.optimization
        return ((opt.max_epoch >= 0 and self.epoch >= opt.max_epoch)
                or (opt.max_iter >= 0 and self.iter >= opt.max_iter))

    # ---------------------------------------------------------------- run

    def run(self):
        accum = max(1, int(self.cfg.optimization.accum_grad or 1))
        t0 = time.time()
        for i, batch in enumerate(self.train_iter, start=1):
            self.event_manager.trigger_epoch_events(self)
            if self.stop():
                break
            loss = self.train_step(to_device(batch, self.device))
            self._loss_accum.append(loss)
            if len(self._loss_accum) > 10000:  # bounded without a trigger
                del self._loss_accum[:5000]
            self._report_utts += int(batch["valid"].sum()) \
                if "valid" in batch else batch["xs"].shape[0]
            if i % accum == 0:
                self.iter += 1
                self.event_manager.trigger_iteration_events(self)
        logger.info("training finished in %.1fs (%d iters, %d epochs)",
                    time.time() - t0, self.iter, self.epoch)

    # ----------------------------------------------- durable results rows

    def _results_append(self, row: dict):
        """Append one JSONL row to ``common.results_file``."""
        path = self.cfg.common.get("results_file")
        if not path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps({"ts": round(time.time(), 1), **row}) + "\n")

    def _emit_run_meta(self, n_params: int):
        from liteasr_tpu_torch.config.core import to_yaml

        cfg_yaml = to_yaml(self.cfg)
        self._results_append({
            "kind": "run_meta",
            "argv": sys.argv[1:],
            "config_sha1": hashlib.sha1(cfg_yaml.encode()).hexdigest()[:12],
            "model": type(self.model).__name__,
            "criterion": type(self.criterion).__name__,
            "n_params": int(n_params),
            "run_dir": self.cfg.common.run_dir,
            "resumed_from_iter": self.iter,
        })

    # ------------------------------------------------------- event bodies

    def report_loss(self):
        if self._loss_accum:
            window = float(torch.stack(self._loss_accum).float().mean())
            self._loss_accum = []
        else:
            window = float("nan")
        now = time.time()
        dt = max(now - self._report_time, 1e-6)
        throughput = self._report_utts / dt
        self._report_time = now
        self._report_utts = 0
        logger.info(
            "%s / %s iters, %s / %s epochs - current loss: %.2f "
            "(%.1f utts/s)",
            self.iter, self.max_iter, self.epoch, self.max_epoch, window,
            throughput)

    def valid(self):
        losses = []
        for idx in range(len(self.valid_set)):
            batch = self.valid_set.collator(self.valid_set[idx])
            loss, _ = self.eval_step(to_device(batch, self.device))
            losses.append(loss)
        reduced = float(torch.stack(losses).float().mean()) if losses \
            else float("nan")
        # keep the exact "valid loss:" phrasing: checkpoint averaging parses
        # it from train.log (liteasr/utils/checkpoint.py:55-67)
        logger.info("%s / %s iters, %s / %s epochs - valid loss: %.2f",
                    self.iter, self.max_iter, self.epoch, self.max_epoch,
                    reduced)
        self._results_append({"kind": "valid", "iter": int(self.iter),
                              "epoch": int(self.epoch), "valid_loss": reduced})

    def save_model(self):
        """``model.ep.<epoch>.pt``: the model's state_dict (parameters and
        BatchNorm running statistics), what checkpoint.load_ckpt reads."""
        state = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        path = os.path.join(self.task.save_dir, CKPT_TEMPLATE.format(self.epoch))
        torch.save(state, path)
        logger.info("saved %s", path)

    def inference(self):
        """Decode the test sets mid-training through ``infer_dataset``."""
        from liteasr_tpu_torch.infer import infer_dataset

        if "test" not in self.task.datasets:
            test_dirs = self.task.cfg.get("test")
            if not test_dirs:
                logger.warning("inference trigger set but task.test is empty")
                return
            self.task.load_dataset("test", list(test_dirs), self.cfg.dataset)
        for test_set in self.task.dataset("test"):
            err, length = infer_dataset(
                self.task, self.model, test_set, self.cfg.inference,
                self.device,
                pad_time_multiple=self.cfg.dataset.get("pad_time_multiple", 128),
                verbose=False)
            logger.info(
                "%s / %s iters, %s / %s epochs - test error rate: "
                "%d / %d = %.2f%%",
                self.iter, self.max_iter, self.epoch, self.max_epoch,
                err, length, 100.0 * err / max(length, 1))
