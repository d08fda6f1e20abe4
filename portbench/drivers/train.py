"""Train driver: micro-steps of the port's ``Trainer.train_step`` on batches
from the port's data path, closed loop, then the step checked against the
plain reference.

Set-up builds one ``Trainer`` (the model with the benchmark's weights
from the seed, ``FusedAdam``, the criterion) over an in-memory
``AudioFileDataset`` (the port's ``FrameBatch`` batchify and collator)
and its ``EpochDataLoader``. Its first ``accum_grad`` micro-steps are the
checked ones: they run through the window's own call and feed, with the
plain dropouts' masks drawn by the benchmark (``reference.draws``). The
loader's first epoch follows, so that every batch shape the window meets
has run once. The window then takes the loader's batches until
``--seconds`` have passed and ends on a synchronize. After it, the
program is freed and the reference follows the checked micro-steps from
the same weights, batches and draws.

:func:`run_family` is that loop; a family (:class:`U2Family` here, the
pretrain driver's for wav2vec 2.0) says what differs between models: the
port's overrides, the corpus, the reference and each batch's audio and
operations.
"""

import gc
import math
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

import flops
import harness
import generator
import weights
from reference import draws, u2 as ref_u2


# the configuration's sizes that the port takes as ``model.*`` overrides
MODEL_KEYS = ("enc_dim", "enc_ff_dim", "enc_attn_heads", "enc_layers", "dec_dim",
              "dec_ff_dim", "dec_attn_heads", "dec_layers", "dropout_rate",
              "enc_dropout_rate", "enc_pos_dropout_rate", "enc_attn_dropout_rate",
              "enc_ff_dropout_rate", "dec_dropout_rate", "dec_pos_dropout_rate",
              "dec_self_attn_dropout_rate", "dec_src_attn_dropout_rate",
              "dec_ff_dropout_rate")


def in_memory_dataset(cfg, utts):
    """The port's ``AudioFileDataset`` over utterances held in memory: its
    own ``batchify`` (length-sorted ``FrameBatch``) and ``collator``."""
    from liteasr_tpu_torch.data.dataset import AudioFileDataset

    ds = AudioFileDataset.__new__(AudioFileDataset)
    ds.split = "train"
    ds.data = utts
    ds.batchify_policy = None
    ds.dataset_cfg = cfg.dataset
    ds.dump_path = None
    ds.postprocess = None  # SpecAugment runs on the device
    ds.batch_multiple, ds.num_shards, ds.shard_index = 1, 1, 0
    ds.fbank, ds.num_mel_bins = False, int(cfg.dataset.num_mel_bins)
    ds.feat_dim = int(utts[0].x.shape[1])
    ds.batchify(cfg.dataset)
    return ds


def leaf_norms(flat: torch.Tensor, named) -> Dict[str, float]:
    """Each leaf's norm of a flat vector laid out as ``named``'s leaves."""
    norms = torch.stack([c.norm() for c in flat.split([p.numel() for _, p in named])])
    return dict(zip((n for n, _ in named), norms.cpu().tolist()))


class U2Family:
    """What the train loop needs to know of the U2 conformer: the port's
    overrides, the in-memory corpus, the reference's layout and follower,
    and each batch's audio, frames and operations."""

    kind = "train"
    aux_keys = ()  # the criterion's outputs compared beside the loss

    def __init__(self, cell: harness.Cell):
        self.cell, self.m, self.mix = cell, cell.config["model"], cell.traffic

    def overrides(self) -> List[str]:
        """The port's config overrides: the configuration's, its sizes, the
        mix's batching, and the run's seed (no trigger event runs)."""
        cfg, mix = self.cell.config, self.mix
        return (list(cfg["port"]["train"]) + list(mix["port"])
                + [f"model.{k}={cfg['model'][k]}" for k in MODEL_KEYS]
                + [f"common.seed={self.cell.seed}", "common.trigger=[]",
                   f"task.vocab_size={self.m['vocab_size']}",
                   f"task.feat_dim={self.m['input_dim']}",
                   f"task.save_dir={harness.ROOT / 'build' / 'portbench' / 'ckpts'}"])

    def dataset(self, cfg):
        utts = generator.utterances(self.mix, self.cell.seed, self.m["input_dim"],
                                  self.m["vocab_size"])
        return in_memory_dataset(cfg, utts)

    def shape_key(self, batch) -> tuple:
        return tuple(batch["xs"].shape[:2]) + tuple(batch["ys"].shape)

    def shape_keys(self, ds, cfg) -> set:
        """Every batch's (B, T, B, U) as the collator pads it, from the lengths."""
        from liteasr_tpu_torch.utils.misc import round_up

        keys = set()
        for i in range(len(ds)):
            utts = ds[i]
            T = round_up(max(u.xlen for u in utts), int(cfg.dataset.pad_time_multiple))
            U = max(1, round_up(max(u.ylen for u in utts), int(cfg.dataset.pad_label_multiple)))
            keys.add((len(utts), T, len(utts), U))
        return keys

    def layout(self):
        return ref_u2.layout(self.m)

    def weights(self, lay):
        return weights.draw(lay, self.cell.seed, self.cell.device)

    def record(self, batch):
        return batch["xs"].shape[:2], batch["xlens"], batch["ylens"]

    def summarize(self, records) -> Dict[str, float]:
        """Real audio seconds, real and padded frames and the operations of
        the recorded batches."""
        real = sum(int(x.sum()) for _, x, _ in records)
        work = sum(flops.u2_train_flops(zip(x.tolist(), y.tolist()), self.m["vocab_size"],
                                        **widths(self.m)) for _, x, y in records)
        return {"audio_s": generator.audio_seconds(real, self.mix), "real_frames": real,
                "padded_frames": sum(int(s[0]) * int(s[1]) for s, _, _ in records),
                "flops": work}

    attn_kernels = ("rel_attn_fwd", "rel_attn_bwd", "bwd_prep_kernel")

    def attn_bound_s(self, batch) -> float:
        """Least time of one micro-step's K1' and K2 calls from their shapes."""
        m = self.m
        H = m["enc_attn_heads"]
        Dk = m["enc_dim"] // H
        B, T = batch["xs"].shape[:2]
        t_sub = flops.subsampled(T)
        pos = np.arange(T)[:-2:2][:-2:2]
        kv = np.repeat([(pos < x).sum() for x in batch["xlens"]], H)
        return m["enc_layers"] * (flops.fwd_bound(B * H, t_sub, t_sub, Dk, kv, lse=True, heads=H)
                                  + flops.bwd_bound(B * H, t_sub, Dk, kv, heads=H))

    def follow(self, cfg, batches, precision: str) -> Dict:
        return follow(self.cell, cfg, batches, precision)


def run(cell: harness.Cell) -> harness.Run:
    return run_family(cell, U2Family(cell))


def run_family(cell: harness.Cell, fam) -> harness.Run:
    from liteasr_tpu_torch import tasks
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.trainer import Trainer, to_device

    dev = cell.device
    np.random.seed(cell.seed % (1 << 32))
    torch.manual_seed(cell.seed)
    cfg = compose(fam.overrides())
    task = tasks.setup_task(cfg.task)
    ds = fam.dataset(cfg)
    task.datasets["train"] = task.datasets["valid"] = ds
    model = task.build_model(cfg.model, device=dev, generator=torch.Generator())
    model.seed_dropout(cell.seed)

    lay = fam.layout()
    named = list(model.named_parameters())
    if {n: tuple(p.shape) for n, p in named} != {n: s for n, s, _ in lay}:
        raise harness.SetupError("the port's parameters differ from the reference's layout")
    init = fam.weights(lay)
    with torch.no_grad():
        for n, p in named:
            p.copy_(init[n])
    del init
    trainer = Trainer(cfg, task, model, task.build_criterion(cfg.criterion),
                      task.build_optimizer(cfg.optimizer), dev)
    tx = trainer.tx
    accum = tx.accum
    if tx.acc is None:
        raise harness.SetupError("the check reads the first gradient from FusedAdam's "
                                 "accumulator: accum_grad must be 2 or more")
    faults(cell, trainer)

    # ---- the checked micro-steps: the window's call and feed, the
    # benchmark's dropout masks
    loader = iter(trainer.train_iter)
    start = torch.cat([p.detach().reshape(-1) for p in trainer.params])
    checked, losses, aux = [], [], []
    real_dropout, criterion = torch.nn.functional.dropout, trainer.criterion

    def recording(model, batch, train=True):
        loss, out = criterion(model, batch, train)
        aux.append({k: float(out[k]) for k in fam.aux_keys})
        return loss, out

    trainer.criterion = recording
    try:
        for k in range(accum):
            batch = next(loader)
            checked.append(batch)
            torch.nn.functional.dropout = draws.Dropouts(cell.seed, k, dev)
            losses.append(float(trainer.train_step(to_device(batch, dev))))
            if k == 0:
                g1 = leaf_norms(tx.acc, trainer.named_params)
    finally:
        torch.nn.functional.dropout = real_dropout
        trainer.criterion = criterion
    change = leaf_norms(torch.cat([p.detach().reshape(-1) for p in trainer.params]) - start,
                        trainer.named_params)
    del start
    program = {"loss": losses, "aux": aux, "grad": g1, "change": change}

    # ---- warm-up: the rest of the loader's first epoch, every shape once
    seen = {fam.shape_key(b) for b in checked}
    shapes = fam.shape_keys(ds, cfg)
    while not shapes <= seen:
        batch = next(loader)
        seen.add(fam.shape_key(batch))
        trainer.train_step(to_device(batch, dev))
    sync(dev)
    skipped0 = int(tx.notfinite_count)
    setup_s = time.perf_counter() - cell.t_start

    # ---- the window: closed loop over the loader
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_losses, records, wait, ends = [], [], 0.0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        ta = time.perf_counter()
        batch = next(loader)
        dbatch = to_device(batch, dev)
        wait += time.perf_counter() - ta
        step_losses.append(trainer.train_step(dbatch))
        records.append(fam.record(batch))
        ends.append(time.perf_counter())
    sync(dev)
    window_s = time.perf_counter() - t0
    print_pace(np.diff([t0] + ends), window_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    skipped = int(tx.notfinite_count) - skipped0
    nonfinite = int((~torch.isfinite(torch.stack(step_losses).float())).sum())

    out = harness.Run(attempted=len(step_losses), memory_peak_bytes=peak)
    out.failed = min(out.attempted, max(nonfinite, skipped * accum))
    out.metrics["setup_s"] = setup_s
    totals = fam.summarize(records)
    out.metrics["train_audio_s_per_s"] = totals.pop("audio_s") / window_s
    out.stats.update(steps=len(step_losses), window_s=window_s, input_wait_s=wait,
                     peak_bytes=peak, kind=fam.kind, **totals)

    if cell.trace:
        out.trace = traced(cell, trainer, loader, to_device, fam)
    if out.trace is not None:
        print(f"tracing: {out.trace['window_s'] / out.trace['steps']!r} s a traced micro-step, "
              f"{window_s / len(step_losses)!r} s an untraced one", file=sys.stderr, flush=True)
    loader.close()

    # ---- the check, once the program is freed
    del trainer, model, task, tx, step_losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference = fam.follow(cfg, checked, "fp32")
    out.checks = compare(program, reference, cell.limits, "program")
    if cell.control == "control":
        out.checks = compare(fam.follow(cfg, checked, "fp8"), reference, cell.limits,
                             "control")
    return out


def widths(m: Dict) -> Dict:
    return dict(feat_dim=m["input_dim"], enc_layers=m["enc_layers"],
                dec_layers=m["dec_layers"], d=m["enc_dim"], ff=m["enc_ff_dim"],
                conv_k=m["conv_kernel"])


def print_pace(steps: np.ndarray, window_s: float):
    """The host's seconds a micro-step in the window, by quarter of the
    window and over it, so that a slow run shows whether it was slow
    throughout or stalled."""
    quarters = [float(q.mean()) for q in np.array_split(steps, 4) if len(q)]
    p10, p50, p90 = (float(np.percentile(steps, q)) for q in (10, 50, 90))
    print(f"pace: {len(steps)} micro-steps in {window_s!r} s; host s a micro-step by quarter "
          f"{quarters!r}; p10 {p10!r} p50 {p50!r} p90 {p90!r} max {float(steps.max())!r}",
          file=sys.stderr, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def faults(cell: harness.Cell, trainer):
    """Break the timed path as the fault tests ask: ``state_unchanged``
    (the update never reaches the parameters) or ``half_batch`` (the
    criterion sees half the rows and takes its mean over them)."""
    if cell.control == "state_unchanged":
        trainer.tx.update = lambda grads: None
    elif cell.control == "half_batch":
        crit = trainer.criterion

        def half(model, batch, train=True):
            keep = max(1, batch["xs"].shape[0] // 2)
            return crit(model, {k: (v[:keep] if torch.is_tensor(v) and v.dim() else v)
                                for k, v in batch.items()}, train)

        trainer.criterion = half


def traced(cell, trainer, loader, to_device, fam):
    """``trace_steps`` more micro-steps under ``torch.profiler``, after the
    window: the device's busy time, kernels and idle gaps, and the least
    time of the attention kernels' calls from their shapes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = cell.device
    steps = int(cell.traffic["trace_steps"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    bound_s = 0.0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("portbench.input"):
                batch = next(loader)
                dbatch = to_device(batch, dev)
            with record_function("portbench.train_step"):
                trainer.train_step(dbatch)
            bound_s += fam.attn_bound_s(batch)
        sync(dev)
        wall = time.perf_counter() - t0
    if dev.type != "cuda":
        return None
    red = harness.reduce_trace(harness.profile_events(prof), wall, steps)
    red["attn_bound_s"] = bound_s
    red["attn_kernels"] = fam.attn_kernels
    return red


# ------------------------------------------------------------------ check

def follow(cell, cfg, batches, precision: str) -> Dict:
    """The plain reference through the checked micro-steps: each one's
    loss, the first one's gradient leaf norms, and the change of every
    leaf after the update at the last one."""
    dev = cell.device
    m = cell.config["model"]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    lay = ref_u2.layout(m)
    P = {n: t.requires_grad_(True) for n, t in weights.draw(lay, cell.seed, dev).items()}
    model = ref_u2.U2Reference(m, ref_u2.Ops(precision))
    crit, opt, sa = cfg.criterion, cfg.optimizer, cfg.postprocess.spec_aug
    seeds = draws.SeedStream(cell.seed)
    total = {n: torch.zeros_like(t) for n, t in P.items()}
    losses, first = [], None
    remat = bool(cell.traffic.get("reference_remat", False))
    for k, batch in enumerate(batches):
        b = {key: torch.from_numpy(np.asarray(v)).to(dev) for key, v in batch.items()}
        for key in ("ys", "xlens", "ylens"):
            b[key] = b[key].long()
        gen = draws.step_generator(cell.seed, k, dev)
        b["xs"] = draws.spec_augment(
            b["xs"], b["xlens"], gen, time_warp=int(sa.time_warp),
            freq_mask=int(sa.freq_mask), freq_mask_times=int(sa.freq_mask_times),
            time_mask=int(sa.time_mask), time_mask_times=int(sa.time_mask_times),
            replace_with_zero=bool(sa.replace_with_zero),
            time_warp_mode=str(sa.time_warp_mode))
        loss = model.loss(P, b, draws.Dropouts(cell.seed, k, dev), seeds,
                          float(crit.ctc_weight), float(crit.smoothing), remat)
        grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        for (n, t), g in zip(P.items(), grads):
            if g is not None:
                total[n] += g
        if k == 0:
            first = {n: (0.0 if g is None else float(g.norm()))
                     for (n, _), g in zip(P.items(), grads)}
        del loss, grads
    count = len(batches)
    lr = ref_u2.noam_lr(0, int(opt.model_dim), float(opt.factor), int(opt.warmup))
    with torch.no_grad():
        mean = {n: g / count for n, g in total.items()}
        after = ref_u2.adam_update({n: t.detach() for n, t in P.items()}, mean, lr,
                                   float(opt.beta1), float(opt.beta2), float(opt.eps),
                                   float(cfg.optimization.clip_grad_norm))
        change = {n: float((after[n] - P[n].detach()).norm()) for n in P}
    return {"loss": losses, "aux": [{} for _ in batches], "grad": first, "change": change}


def compare(program: Dict, reference: Dict, limits: Dict, label: str) -> List[Dict]:
    """The numbers compared, each beside its limit: the largest relative
    gap of a micro-step's loss, and of each criterion output of
    ``aux`` (``<key>_gap``); by the worst leaf, the gap between the
    first gradient's norms against the reference's norm of that leaf or
    of the median leaf, whichever is larger; and the median leaf's gap
    between the norms of the update's change, so measured. Leaves whose
    reference gradient is under a thousandth of the median leaf's (zero
    in exact arithmetic, moved by round-off alone) are left out of the
    change. The worst leaves, and every number (also those the cell's
    limits leave out), are printed under ``label``."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], reference["loss"]))
    if not all(math.isfinite(v) for v in program["loss"]):
        loss_gap = math.inf
    g_ref = reference["grad"]
    g_med = statistics.median(g_ref.values())
    grads = {n: abs(program["grad"][n] - r) / max(r, g_med) for n, r in g_ref.items()}
    c_ref = reference["change"]
    counted = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = statistics.median(c_ref[n] for n in counted)
    changes = {n: abs(program["change"][n] - c_ref[n]) / max(c_ref[n], c_med) for n in counted}
    for what, gaps, ref in (("grad", grads, g_ref), ("change", changes, c_ref)):
        worst = max(gaps, key=gaps.get)
        print(f"{label} worst {what} leaf: {worst} gap {gaps[worst]!r} reference norm {ref[worst]!r} "
              f"(median leaf {statistics.median(ref[n] for n in gaps)!r}; median gap "
              f"{statistics.median(gaps.values())!r})", file=sys.stderr, flush=True)
    values = {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
              "change_gap": statistics.median(changes.values())}
    for key in program["aux"][0]:
        gaps = [abs(p[key] - r[key]) / abs(r[key])
                for p, r in zip(program["aux"], reference["aux"])]
        values[f"{key}_gap"] = max(gaps) if all(map(math.isfinite, gaps)) else math.inf
    print(f"{label} gaps: " + " ".join(f"{n}={v!r}" for n, v in values.items()),
          file=sys.stderr, flush=True)
    # a number the cell's limits leave out has no upper reading there (PERF.md)
    return [{"name": n, "value": v if math.isfinite(v) else 1e30, "limit": limits[n]}
            for n, v in values.items() if n in limits]

