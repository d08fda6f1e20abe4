"""Trainer: the train step on one ``torch.device`` and the host event loop
(liteasr_tpu/trainer.py; reference liteasr/trainer.py:28-227).

One micro-step is the front end (log-mel fbank of raw-wave batches, then
SpecAugment when ``postprocess.on_device`` and the workflow has
``spec_aug``), the criterion's forward (dropout on, BatchNorm on batch
statistics), ``backward`` and :class:`optims.fused_step.FusedAdam`'s update,
which accumulates ``accum_grad`` micro-steps, clips the mean gradient's
global norm and skips a non-finite step. As in the reference, BatchNorm's
running statistics move on every micro-step, a skipped one included
(liteasr_tpu/trainer.py:268-272). The trigger events ``report_loss``,
``valid``, ``save_model`` and ``inference`` run on the host between steps.

``save_model`` also writes ``train_state.pt`` (and ``.meta`` with ``iter``
and ``epoch``) to ``task.save_dir``: the model's state_dict, the
optimizer's moments, counts and partial accumulation, the micro-step count
that seeds SpecAugment, and the model's own generators: the rel-pos
attention dropout's, the dynamic chunk widths', the Paraformer's glance
noise's and wav2vec 2.0's span masks', negatives' and Gumbel noise's.
``common.resume`` (``auto`` or a path) restores it, so that a resumed run
continues as the uninterrupted one would have (liteasr_tpu/trainer.py:
314-375). A ``deadline`` (a ``time.time()`` value) ends the run at the first
epoch boundary past it, after that epoch's events, so the run stops with
its last save whole. ``common.profile_dir`` traces the run with ``torch.profiler``
into a Chrome trace there, with the spans of ``utils.tracing`` (the micro-step
and its forward, backward and optimizer phases, the loader's wait and its
workers' collation, the copy to the device) appended as rows of their own.

Under a process group (``parallel.distributed_init``; liteasr_tpu/trainer.py
:150-159, 336-370, 454, 492, 532-578) each rank trains on its row shard of
the global batch: the datasets' ``num_shards``/``shard_index`` pick it and
every rank shuffles with the same seed, so the ranks stay in lockstep. The
criterion's loss is the rank's share of the global batch's, the optimizer
sums the flat gradient over the ranks at each applied step, ``valid`` and
``report_loss`` sum the ranks' shares, and ``inference`` decodes on every
rank (``infer_dataset`` gathers the hypotheses). The master alone writes
logs to file, results rows and checkpoints; ``train_state.pt`` holds every
rank's generator states (``rng_ranks``), and every rank reads it on resume.
The per-row random streams (device dropout, SpecAugment, the Paraformer's
glance noise, wav2vec 2.0's draws) are seeded per rank (rank 0 keeps the
one-process streams); the attention kernels' dropout seeds move to the
rank's rows.

Under tensor and sequence parallelism (every family;
``parallel.sharding``) the ranks form a (dp, sp, tp) mesh: the
datasets are sharded by the dp coordinate, so tp and sp peers collate the same rows; the batch-level draws
(SpecAugment) follow dp_i; the throughput counts each global row once.
``save_model`` gathers the tp shards (a collective) and sums a partial
gradient accumulation over the dp x sp ranks (each holds its share until
the applying micro-step), and the master writes the one-process layout,
parameters and optimizer state alike, so that a checkpoint or train state
of any layout loads in any other; resume cuts the rank's shard from it,
and the first rank of the dp x sp group takes the whole accumulation. ``valid`` runs the sharded eval forward;
``inference`` decodes the gathered full model, its rows sharded over the
world as under dp.
"""

import hashlib
import json
import logging
import os
import sys
import time
from typing import Optional

import torch

from liteasr_tpu_torch import parallel
from liteasr_tpu_torch.checkpoint import CKPT_TEMPLATE
from liteasr_tpu_torch.parallel import sharding
from liteasr_tpu_torch.data.loader import EpochDataLoader, host_tensor
from liteasr_tpu_torch.ops.fbank import log_mel_fbank
from liteasr_tpu_torch.ops.spec_augment import spec_augment, step_generator
from liteasr_tpu_torch.optims.fused_step import build_tx
from liteasr_tpu_torch.utils import tracing
from liteasr_tpu_torch.utils.trigger import EventManager

TRAIN_STATE = "train_state.pt"
# the CPU generators a model may own (``<key>_generator``), saved for resume
MODEL_GENERATORS = ("dropout", "chunk", "glance", "mask", "negatives", "gumbel")

logger = logging.getLogger(__name__)


def to_device(batch, device):
    """numpy batch dict -> tensors on ``device`` (ids as int64); the
    ``data.to_device`` span. A value that the batch carries page-locked
    (``loader.PinnedBatch``) crosses on a copy that the host does not wait
    for; from pageable memory the copy waits for the stream to drain. The
    counters ``data.h2d_pinned_bytes`` and ``data.h2d_pageable_bytes``
    take each kind's bytes."""
    pinned = getattr(batch, "pinned", {})
    out, nbytes = {}, {True: 0, False: 0}
    with tracing.span("data.to_device", device):
        for key, val in batch.items():
            t = pinned.get(key)
            locked = t is not None and t.is_pinned()
            if t is None:
                t = host_tensor(key, val)
            nbytes[locked] += t.numel() * t.element_size()
            out[key] = t.to(device, non_blocking=True)
        tracing.add("data.h2d_pinned_bytes", nbytes[True])
        tracing.add("data.h2d_pageable_bytes", nbytes[False])
    return out


class Trainer:
    def __init__(self, cfg, task, model, criterion, optimizer,
                 device: torch.device, deadline: Optional[float] = None):
        self.cfg = cfg
        self.deadline = deadline
        self.task = task
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.iter = 0
        self.step = 0  # micro-steps taken (the JAX TrainState.step)
        self._loss_accum = []
        self._report_time = time.time()
        self._report_utts = 0
        self.world, self.rank = parallel.process_count(), parallel.process_index()
        self.layout = parallel.layout()
        self.backend = (torch.distributed.get_backend()
                        if parallel.is_initialized() else None)
        if self.backend:
            lay = self.layout
            logger.info("rank %d of %d over %s: dp %d x sp %d x tp %d, at (%d, %d, %d)",
                        self.rank, self.world, self.backend, lay.dp, lay.sp, lay.tp,
                        lay.dp_i, lay.sp_i, lay.tp_i)

        # one device per process: each dp rank collates its row block of the
        # global batch, padded to a multiple of dp; its tp and sp peers
        # collate the same rows
        for ds in (task.dataset("train"), task.dataset("valid")):
            ds.batch_multiple = 1
            ds.num_shards = self.layout.dp
            ds.shard_index = self.layout.dp_i
        self.train_iter = EpochDataLoader(
            task.dataset("train"), shuffle=True, seed=cfg.common.seed,
            prefetch=2, num_workers=max(1, cfg.dataset.get("num_workers", 2)),
            pin_memory=self.device.type == "cuda")
        self.valid_set = task.dataset("valid")

        named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
        sharded = dict(zip((k for k, _ in model.named_parameters()),
                           sharding.sharded_parameters(model)))
        self.named_params = named
        self.params = [p for _, p in named]
        n_params = sum(p.numel() for p in self.params)
        logger.info("model parameters: %.2fM", n_params / 1e6)
        self.tx = build_tx(optimizer, cfg.optimization, self.params,
                           [sharded[k] for k, _ in named])
        self.fbank_bins = (int(cfg.dataset.get("num_mel_bins", 80))
                           if cfg.dataset.get("fbank", False) else None)
        pp = cfg.get("postprocess") or {}
        self.spec_aug = None
        if pp.get("on_device", False) and "spec_aug" in (pp.get("workflow") or []):
            sa = pp.get("spec_aug") or {}
            self.spec_aug = dict(
                time_warp=int(sa.get("time_warp", 5)),
                time_warp_mode=str(sa.get("time_warp_mode", "bicubic")),
                freq_mask=int(sa.get("freq_mask", 30)),
                freq_mask_times=int(sa.get("freq_mask_times", 2)),
                time_mask=int(sa.get("time_mask", 40)),
                time_mask_times=int(sa.get("time_mask_times", 2)),
                replace_with_zero=bool(sa.get("replace_with_zero", False)))
        self._maybe_resume()
        self._epoch_seen = self.epoch  # the deadline is read when this moves
        self._emit_run_meta(n_params)
        self._add_events()

    # ------------------------------------------------------------- step

    def frontend(self, batch):
        """Raw-wave batches (B, S) -> log-mel features (B, T, bins) on the
        device (liteasr_tpu/trainer.py:301-312); features pass through."""
        if self.fbank_bins is None or batch["xs"].dim() != 2:
            return batch
        feats, feat_lens = log_mel_fbank(batch["xs"], batch["xlens"],
                                         num_mel_bins=self.fbank_bins)
        return dict(batch, xs=feats, xlens=feat_lens.long())

    def train_step(self, batch) -> torch.Tensor:
        """One micro-step on a device batch; returns the detached loss.
        Spans: ``train.step`` around ``train.forward``, ``train.backward``
        and ``train.optimizer`` (``utils.tracing``)."""
        dev = self.device
        with tracing.span("train.step", dev, step=self.step):
            with tracing.span("train.forward", dev):
                batch = self.frontend(batch)
                if self.spec_aug is not None and batch["xs"].dim() == 3:  # not raw waves
                    gen = step_generator(
                        parallel.rank_seed(self.cfg.common.seed, self.layout.dp_i),
                        self.step, dev)
                    batch = dict(batch, xs=spec_augment(batch["xs"], batch["xlens"], gen,
                                                        **self.spec_aug))
                # the criterion sees the micro-steps taken before this one, as
                # JAX's batch["step"] = state.step (the glancing-ratio schedule
                # reads it)
                batch = dict(batch, step=self.step)
                self.step += 1
                loss, _ = self.criterion(self.model, batch, train=True)
            with tracing.span("train.backward", dev):
                loss.backward()
            with tracing.span("train.optimizer", dev):
                self.tx.update([p.grad for p in self.params])
                for p in self.params:
                    p.grad = None
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch):
        loss, aux = self.criterion(self.model, self.frontend(batch), train=False)
        return loss, aux

    # ------------------------------------------------------------ resume

    def _train_state_path(self) -> str:
        return os.path.join(self.task.save_dir, TRAIN_STATE)

    def _rng_state(self) -> dict:
        rng = {"cpu": torch.get_rng_state()}
        for key in MODEL_GENERATORS:
            if hasattr(self.model, f"{key}_generator"):
                rng[key] = getattr(self.model, f"{key}_generator").get_state()
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        streams = parallel.stream_states()
        if streams:
            rng["streams"] = streams
        return rng

    def _optimizer_state(self) -> dict:
        """The optimizer's state in the full layout (collectives over the tp
        group and, for a partial accumulation, the dp x sp group: every rank
        calls it). The accumulated gradient is each rank's share until the
        applying micro-step all-reduces it, so the one-process layout's is
        the sum of the dp x sp ranks'."""
        tx = self.tx

        def full(vec):
            return None if vec is None else sharding.gather_flat(vec, self.named_params)

        acc = tx.acc
        if acc is not None and self.layout.dp * self.layout.sp > 1:
            acc = parallel.global_sum_(acc.clone(), "state")
        return {"mu": full(tx.mu), "nu": full(tx.nu), "count": tx.count.cpu(),
                "notfinite_count": tx.notfinite_count.cpu(), "acc": full(acc),
                "nu_max": full(tx.nu_max), "mini_step": tx.mini_step}

    def _save_train_state(self, model_state, opt_state, rng_ranks):
        """``rng_ranks``: every rank's ``_rng_state()``, rank 0's first."""
        state = {
            "model": model_state,
            "optimizer": opt_state,
            "step": self.step,
            "rng": rng_ranks[0],
        }
        if self.world > 1:
            state["rng_ranks"] = rng_ranks
        path = self._train_state_path()
        torch.save(state, path)
        with open(path + ".meta", "w") as f:
            json.dump({"iter": self.iter, "epoch": self.epoch}, f)

    def _maybe_resume(self):
        resume = self.cfg.common.get("resume")
        if not resume:
            return
        path = str(resume) if resume != "auto" and os.path.isfile(str(resume)) \
            else self._train_state_path()
        if not os.path.isfile(path):
            logger.warning("resume requested but %s not found; starting fresh", path)
            return
        state = torch.load(path, map_location="cpu", weights_only=True)
        tx, opt = self.tx, dict(state["optimizer"])
        lay = self.layout
        try:
            model_state = state["model"]
            if getattr(self.model, "tp_sharded", False):  # the rank's shard of the full layout
                shapes = {k: model_state[k].shape for k, _ in self.named_params}
                model_state = sharding.shard_state_dict(model_state, lay.tp_i, lay.tp)
                for key in ("mu", "nu", "acc", "nu_max"):
                    if opt.get(key) is not None:
                        opt[key] = sharding.shard_flat(opt[key], self.named_params, shapes)
            self.model.load_state_dict(model_state, strict=True)
            nu_max = opt.get("nu_max")
            if (opt["mu"].shape != tx.mu.shape or (opt["acc"] is None) != (tx.acc is None)
                    or (nu_max is None) != (tx.nu_max is None)):
                raise ValueError(
                    f"optimizer state of {opt['mu'].numel()} parameters "
                    f"(accumulating: {opt['acc'] is not None}, amsgrad: "
                    f"{nu_max is not None}) against {tx.mu.numel()} "
                    f"(accumulating: {tx.acc is not None}, amsgrad: "
                    f"{tx.nu_max is not None})")
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                f"cannot restore {path}: its layout does not match this run's "
                "model and optimizer; resume with the model config and "
                f"optimization.accum_grad and optimizer.amsgrad the run was "
                f"started with ({e})") from e
        for name in ("mu", "nu", "count", "notfinite_count"):
            getattr(tx, name).copy_(opt[name])
        if tx.acc is not None:  # the whole sum on one rank of the dp x sp group
            tx.acc.copy_(opt["acc"])
            if lay.dp_i or lay.sp_i:
                tx.acc.zero_()
        if tx.nu_max is not None:
            tx.nu_max.copy_(opt["nu_max"])
        tx.mini_step = int(opt["mini_step"])
        self.step = int(state["step"])
        ranks = state.get("rng_ranks") or [state["rng"]]
        if self.rank < len(ranks):
            self._set_rng_state(ranks[self.rank])
        else:  # a run saved by fewer processes: this rank keeps fresh streams
            logger.warning("%s holds the generator states of %d rank(s); rank %d "
                           "starts its own streams afresh", path, len(ranks), self.rank)
        meta_path = path + ".meta"
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.iter = int(meta.get("iter", 0))
            self.train_iter.epoch = int(meta.get("epoch", 0))
        logger.info("resumed training state from %s (iter %d, epoch %d)",
                    path, self.iter, self.epoch)

    def _set_rng_state(self, rng: dict):
        torch.set_rng_state(rng["cpu"])
        parallel.set_stream_states(rng.get("streams") or {})
        for key in MODEL_GENERATORS:
            if key in rng and hasattr(self.model, f"{key}_generator"):
                getattr(self.model, f"{key}_generator").set_state(rng[key])
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"], self.device)

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
                or (opt.max_iter >= 0 and self.iter >= opt.max_iter)
                or self._past_deadline())

    def _past_deadline(self) -> bool:
        """At an epoch's first micro-step: whether ``deadline`` has passed
        on any rank (so that the ranks stop together)."""
        if self.deadline is None or self.epoch == self._epoch_seen:
            return False
        self._epoch_seen = self.epoch
        past = time.time() >= self.deadline
        if self.world > 1:
            past = any(parallel.all_gather_object(past))
        if past:
            logger.info("deadline passed: stopping after epoch %d", self.epoch)
        return past

    # ---------------------------------------------------------------- run

    def run(self):
        profile_dir = self.cfg.common.get("profile_dir")
        if not profile_dir or not parallel.is_master():
            return self._run()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        tracing.reset()
        with profile(activities=activities) as prof:
            self._run()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        tracing.export_chrome_trace(path)
        logger.info("wrote the run's torch.profiler trace and spans to %s", path)

    def _run(self):
        accum = max(1, int(self.cfg.optimization.accum_grad or 1))
        t0 = time.time()
        for batch in self.train_iter:
            self.event_manager.trigger_epoch_events(self)
            if self.stop():
                break
            loss = self.train_step(to_device(batch, self.device))
            self._loss_accum.append(loss)
            if len(self._loss_accum) > 10000:  # bounded without a trigger
                del self._loss_accum[:5000]
            self._report_utts += int(batch["valid"].sum()) \
                if "valid" in batch else batch["xs"].shape[0]
            if self.step % accum == 0:
                self.iter += 1
                self.event_manager.trigger_iteration_events(self)
        logger.info("training finished in %.1fs (%d iters, %d epochs)",
                    time.time() - t0, self.iter, self.epoch)

    # ----------------------------------------------- durable results rows

    def _results_append(self, row: dict):
        """Append one JSONL row to ``common.results_file`` (the master)."""
        path = self.cfg.common.get("results_file")
        if not path or not parallel.is_master():
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
        """The mean loss of the window on the global batch (the sum of the
        ranks' shares) and the throughput of every rank together."""
        if self._loss_accum:
            window = float(parallel.global_sum_(
                torch.stack(self._loss_accum).float().mean(), "metrics"))
            self._loss_accum = []
        else:
            window = float("nan")
        now = time.time()
        dt = max(now - self._report_time, 1e-6)
        throughput = self._report_utts * self.layout.dp / dt  # each global row once
        self._report_time = now
        self._report_utts = 0
        logger.info(
            "%s / %s iters, %s / %s epochs - current loss: %.2f "
            "(%.1f utts/s)",
            self.iter, self.max_iter, self.epoch, self.max_epoch, window,
            throughput)

    def valid(self):
        """The mean validation loss and the mean of each scalar the criterion
        returns beside it, as ``valid loss: %.2f | key: %.4f ...`` (keys
        sorted) and in the ``results_file`` row (liteasr_tpu/trainer.py:
        501-529). Under a process group, of the global batches: the ranks'
        shares are summed in one all-reduce."""
        losses, extras = [], []
        for idx in range(len(self.valid_set)):
            batch = self.valid_set.collator(self.valid_set[idx])
            loss, aux = self.eval_step(to_device(batch, self.device))
            losses.append(loss)
            extras.append({k: v for k, v in aux.items()
                           if torch.is_tensor(v) and v.dim() == 0})
        keys = list(extras[0]) if extras else []
        if losses:  # (batches, 1 + keys): the loss, then each aux scalar
            table = torch.stack([torch.stack([l.float()] + [e[k].float() for k in keys])
                                 for l, e in zip(losses, extras)])
            table = [float(col.contiguous().mean())
                     for col in parallel.global_sum_(table, "metrics").unbind(1)]
        else:
            table = [float("nan")]
        reduced = table[0]
        means = dict(zip(keys, table[1:]))
        suffix = "".join(f" | {k}: {v:.4f}" for k, v in sorted(means.items()))
        # keep the exact "valid loss:" phrasing: checkpoint averaging parses
        # it from train.log (liteasr/utils/checkpoint.py:55-67)
        logger.info("%s / %s iters, %s / %s epochs - valid loss: %.2f%s",
                    self.iter, self.max_iter, self.epoch, self.max_epoch,
                    reduced, suffix)
        self._results_append({"kind": "valid", "iter": int(self.iter),
                              "epoch": int(self.epoch), "valid_loss": reduced,
                              **{k: round(v, 6) for k, v in means.items()}})

    def save_model(self):
        """``model.ep.<epoch>.pt``: the model's state_dict (parameters and
        BatchNorm running statistics), what checkpoint.load_ckpt reads; and
        the training state that ``common.resume`` restores."""
        # collectives: every rank reaches them, the master writes the
        # one-process layout
        rng_ranks = parallel.all_gather_object(self._rng_state())
        state = sharding.gather_state_dict(self.model)
        opt_state = self._optimizer_state()
        if not parallel.is_master():
            return
        path = self.task.save_model(CKPT_TEMPLATE.format(self.epoch), state)
        self._save_train_state(state, opt_state, rng_ranks)
        logger.info("saved %s and %s", path, TRAIN_STATE)

    def full_model(self):
        """The model in the one-process layout: the model itself, or under
        tensor or sequence parallelism a full copy of the gathered shards (a
        collective over the tp group)."""
        if not (getattr(self.model, "tp_sharded", False)
                or getattr(self.model, "seq_parallel", False)):
            return self.model
        state = sharding.gather_state_dict(self.model)
        model = self.task.build_model(self.cfg.model, device=self.device,
                                      generator=torch.Generator())  # not the run's streams
        model.load_state_dict(state, strict=True)
        return model

    def inference(self):
        """Decode the test sets mid-training through ``infer_dataset``. Every
        rank decodes: under a process group each decodes its row block of a
        batch and the hypotheses are gathered (a collective, so a
        master-only return would stall the others); the master logs."""
        from liteasr_tpu_torch.infer import infer_dataset

        if "test" not in self.task.datasets:
            test_dirs = self.task.cfg.get("test")
            if not test_dirs:
                logger.warning("inference trigger set but task.test is empty")
                return
            self.task.load_dataset("test", list(test_dirs), self.cfg.dataset)
        model = self.full_model()
        for test_set in self.task.dataset("test"):
            err, length = infer_dataset(
                self.task, model, test_set, self.cfg.inference,
                self.device,
                pad_time_multiple=self.cfg.dataset.get("pad_time_multiple", 128),
                verbose=False)
            if not parallel.is_master():
                continue
            logger.info(
                "%s / %s iters, %s / %s epochs - test error rate: "
                "%d / %d = %.2f%%",
                self.iter, self.max_iter, self.epoch, self.max_epoch,
                err, length, 100.0 * err / max(length, 1))
