"""Data-parallel train driver: the U2 conformer's micro-steps through the
port's ``Trainer.train_step`` on ``chips`` ranks, one process and one card
a rank, dp over NCCL through the port's ``parallel.distributed_init``.

Rank 0 runs in ``run.py``'s process and starts the other ranks itself, each
as ``python3 portbench/drivers/train_dp.py <cell file> <rank> <address>``
from a file of the cell as rank 0 holds it. Every rank builds the same
``Trainer`` with the seed's weights over the same corpus; the port's
dataset hands each rank its block of rows of every global ``FrameBatch``
(``num_shards`` the world, ``shard_index`` the rank), so that the ranks
step in lockstep. Ranks that share a device (the CPU, or fewer cards than
ranks) join over gloo instead, which NCCL refuses.

The window: every rank takes micro-steps until rank 0's clock has passed
``--seconds``, read at each update's boundary through a flag summed over
a gloo group. Reported: ``train_audio_s_per_s``, the real audio of every
rank over rank 0's window; ``flops``, every rank's operations over the
world, so that ``train_mfu_pct`` stays one card's share; the fullest
rank's peak memory; rank 0's input wait, trace and spans.

The check: the ranks' checked micro-steps take the benchmark's dropout
masks, a batch-shaped tensor's mask being the rank's block of the global
batch's (:class:`ShardDropouts`); rank 0 gathers the global batches, the
loss and the first gradient summed over the ranks, and the change after
the update, which is the same on every rank. The reference follows the
global batches in one process, each rank's block of rows SpecAugmented by
that rank's draws: the port's dp step is one process's step on the global
batch (BatchNorm's statistics and the loss's count are the global
batch's).
"""

import gc
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

if __name__ == "__main__":  # a rank started by rank 0
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parents[2])]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import harness  # noqa: E402
from reference import draws, update  # noqa: E402
from reference import u2 as ref_u2  # noqa: E402

train = harness.load_module("drivers", "train")

# a frozen copy of liteasr_tpu_torch/parallel/mesh.py's per-rank seed stride
RANK_SEED_STRIDE = 0x9E3779B1
RANK_SALT = 0x5EED5A1D  # keys a rank's block of a dropout mask
JOIN_S = 300  # the other ranks' time to finish after rank 0's last collective


def rank_seed(seed: int, rank: int) -> int:
    """The port's per-rank seed (``parallel.rank_seed``): the run's on rank 0."""
    return int(seed) if rank == 0 else (int(seed) + rank * RANK_SEED_STRIDE) % (1 << 32)


class ShardDropouts(draws.Dropouts):
    """The benchmark's dropout masks under dp. A tensor of ``rows`` rows for
    each rank of ``ranks`` (the rank itself on a rank; every rank in the
    reference's global batch) takes, in rank r's block, the mask keyed by
    r; any other tensor (the positional encodings) the same mask on every
    rank. Rank 0's masks are the one-process masks."""

    def __init__(self, seed: int, step: int, device, rows: int, ranks):
        super().__init__(seed, step, device)
        self.rows, self.ranks = int(rows), tuple(ranks)

    def keep(self, shape, rate: float) -> torch.Tensor:
        if shape[0] != self.rows * len(self.ranks):
            return super().keep(shape, rate)
        blocks = []
        for r in self.ranks:
            gen = torch.Generator(device=self.device)
            gen.manual_seed((self.seed * 1_000_003 + self.step * 65_537 + self.index * 7919
                             + 12_345 + r * RANK_SALT) % (1 << 62))
            blocks.append(torch.rand((self.rows, *shape[1:]), generator=gen,
                                     device=self.device) >= rate)
        self.index += 1
        return torch.cat(blocks)


class DpFamily(train.U2Family):
    """The U2 family on one rank of ``world``: its block of each global
    batch's rows, its real rows' audio, and the reference's global step."""

    def __init__(self, cell: harness.Cell, world: int):
        super().__init__(cell)
        self.world = world

    def shape_keys(self, ds, cfg) -> set:
        """Every batch's (rows, T, rows, U) as the collator pads a rank's
        block: the global batch's rows padded to a multiple of the world."""
        keys = set()
        for B, T, _, U in super().shape_keys(ds, cfg):
            rows = -(-B // self.world)
            if rows < 2:  # a rank's rows would not tell a batch-shaped mask apart
                raise harness.SetupError(f"a batch of {B} rows leaves a rank fewer than 2")
            keys.add((rows, T, rows, U))
        return keys

    def record(self, batch):
        """The batch's shape and its real rows' lengths (the collator's
        dummy rows, which pad the global batch to the world, carry none)."""
        real = np.asarray(batch["valid"]) > 0
        return batch["xs"].shape[:2], batch["xlens"][real], batch["ylens"][real]

    def follow(self, cfg, batches, precision: str):
        cell, world, dev = self.cell, self.world, self.cell.device
        model = ref_u2.U2Reference(self.m, ref_u2.Ops(precision))
        seeds = draws.SeedStream(cell.seed)
        crit = cfg.criterion
        remat = bool(self.mix.get("reference_remat", False))

        def step(P, k, b):
            rows = b["xs"].shape[0] // world
            b["xs"] = torch.cat([
                update.spec_augment(b["xs"][r * rows:(r + 1) * rows],
                                    b["xlens"][r * rows:(r + 1) * rows], cfg,
                                    draws.step_generator(rank_seed(cell.seed, r), k, dev))
                for r in range(world)])
            loss = model.loss(P, b, ShardDropouts(cell.seed, k, dev, rows, range(world)),
                              seeds, float(crit.ctc_weight), float(crit.smoothing), remat)
            grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
            return float(loss.detach()), {n: (torch.zeros_like(t) if g is None else g)
                                          for (n, t), g in zip(P.items(), grads)}

        return update.follow(cell.seed, dev, cfg, batches, self.layout(), step)


def compare(program, reference, limits, label):
    """``train.compare``, with the change compared over the counted leaves
    that the reference's update or the program's moved, its median leaf
    over those the reference moved. The collator's weight-0 dummy rows,
    which pad a global batch to the world, have zero features; at zero
    biases their LayerNorms see zero variance, and their gradient through
    BatchNorm's statistics grows by 1/sqrt(eps) at each, so that the clip
    leaves most leaves' first update under rounding, in the program and in
    the reference alike (PERF.md). Where every counted leaf moved, this is
    ``train.compare``."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], reference["loss"]))
    if not all(math.isfinite(v) for v in program["loss"]):
        loss_gap = math.inf
    g_ref, c_ref, c_prog = reference["grad"], reference["change"], program["change"]
    g_med = statistics.median(g_ref.values())
    grads = {n: abs(program["grad"][n] - r) / max(r, g_med) for n, r in g_ref.items()}
    counted = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    moved = [n for n in counted if c_ref[n] > 0 or c_prog[n] > 0]
    ref_moved = [c_ref[n] for n in moved if c_ref[n] > 0]
    if ref_moved:
        c_med = statistics.median(ref_moved)
        changes = {n: abs(c_prog[n] - c_ref[n]) / max(c_ref[n], c_med) for n in moved}
    else:  # a reference update that moved nothing checks nothing
        changes = {"(no leaf)": math.inf}
    print(f"{label}: {len(counted) - len(moved)} of {len(counted)} counted leaves unmoved "
          f"by both updates", file=sys.stderr, flush=True)
    for what, gaps, ref in (("grad", grads, g_ref), ("change", changes, c_ref)):
        worst = max(gaps, key=gaps.get)
        print(f"{label} worst {what} leaf: {worst} gap {gaps[worst]!r} reference norm "
              f"{ref.get(worst)!r} (median gap {statistics.median(gaps.values())!r})",
              file=sys.stderr, flush=True)
    values = {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
              "change_gap": statistics.median(changes.values())}
    print(f"{label} gaps: " + " ".join(f"{n}={v!r}" for n, v in values.items()),
          file=sys.stderr, flush=True)
    return [{"name": n, "value": v if math.isfinite(v) else 1e30, "limit": limits[n]}
            for n, v in values.items() if n in limits]


# ------------------------------------------------------------------ ranks

def run(cell: harness.Cell) -> harness.Run:
    """Rank 0: start the other ranks, run its own, and return the run."""
    world = cell.chips
    if world < 2:
        raise harness.SetupError("the dp driver needs a cell of 2 or more chips")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    spec = {k: getattr(cell, k) for k in ("name", "config_name", "traffic_name", "chips",
                                          "config", "traffic", "limits", "seed", "seconds",
                                          "trace", "control")}
    spec["device"] = cell.device.type
    path = harness.ROOT / "build" / "portbench" / f"dp_cell_{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(spec))
    ranks = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(path),
                               str(r), address], stdout=sys.stderr)
             for r in range(1, world)]
    done = threading.Event()
    threading.Thread(target=_watch, args=(ranks, done), daemon=True).start()
    failed = True
    try:
        out = run_rank(cell, 0, world, address)
        failed = False
        return out
    finally:
        done.set()
        path.unlink(missing_ok=True)
        for p in ranks:
            try:
                p.wait(timeout=1 if failed else JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _watch(ranks, done: threading.Event):
    """End rank 0's process at once if another rank fails before rank 0 is
    ``done``: rank 0 would otherwise wait in a collective for ever."""
    while not done.wait(0.5):
        for r, p in enumerate(ranks, start=1):
            code = p.poll()
            if code not in (None, 0):
                print(f"portbench: rank {r} failed with exit code {code}", file=sys.stderr,
                      flush=True)
                os._exit(3)


def run_rank(cell: harness.Cell, rank: int, world: int, address: str):
    """One rank's set-up, checked micro-steps, window and traced steps; on
    rank 0 the :class:`harness.Run`, the others return None."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config import compose

    dist = torch.distributed
    dev = cell.device
    if dev.type != "cuda" or torch.cuda.device_count() < world:
        dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=world,
                                rank=rank)
    fam = DpFamily(cell, world)
    cfg = compose(fam.overrides() + [f"distributed.coordinator_address={address}",
                                     f"distributed.num_processes={world}",
                                     f"distributed.process_id={rank}"])
    parallel.distributed_init(cfg.distributed, dev)
    try:
        steps = _steps(cell, fam, cfg, rank, world, dist.new_group(backend="gloo"))
    finally:
        parallel.destroy()
    if steps is None:
        return None
    # ---- rank 0's check, once the program and the group are gone
    out, program, batches = steps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference = fam.follow(cfg, batches, "fp32")
    out.checks = compare(program, reference, cell.limits, "program")
    if cell.control == "control":
        out.checks = compare(fam.follow(cfg, batches, "fp8"), reference, cell.limits,
                             "control")
    return out


def _steps(cell, fam, cfg, rank, world, flags):
    """The rank's micro-steps; on rank 0 the run without its checks, the
    program's checked numbers and the global checked batches."""
    from liteasr_tpu_torch import parallel, tasks
    from liteasr_tpu_torch.trainer import Trainer, to_device

    dist, dev = torch.distributed, cell.device
    np.random.seed(rank_seed(cell.seed, rank) % (1 << 32))
    torch.manual_seed(cell.seed)
    task = tasks.setup_task(cfg.task)
    ds = fam.dataset(cfg)
    task.datasets["train"] = task.datasets["valid"] = ds
    model = task.build_model(cfg.model, device=dev, generator=torch.Generator())
    model.seed_dropout(cell.seed, rank)
    lay = fam.layout()
    named = list(model.named_parameters())
    if {n: tuple(p.shape) for n, p in named} != {n: s for n, s, _ in lay}:
        raise harness.SetupError("the port's parameters differ from the reference's layout")
    init = fam.weights(lay)
    with torch.no_grad():
        for n, p in named:
            p.copy_(init[n])
    del init
    torch.manual_seed(rank_seed(cell.seed, rank))  # each rank's own dropout in the window
    trainer = Trainer(cfg, task, model, task.build_criterion(cfg.criterion),
                      task.build_optimizer(cfg.optimizer), dev)
    tx = trainer.tx
    accum = tx.accum
    if tx.acc is None:
        raise harness.SetupError("the check reads the first gradient from FusedAdam's "
                                 "accumulator: accum_grad must be 2 or more")
    train.faults(cell, trainer)

    # ---- the checked micro-steps, with the benchmark's masks; the loss and
    # the first gradient summed over the ranks
    loader = iter(trainer.train_iter)
    start = torch.cat([p.detach().reshape(-1) for p in trainer.params])
    checked, losses = [], []
    real_dropout = torch.nn.functional.dropout
    try:
        for k in range(accum):
            batch = next(loader)
            checked.append({key: np.asarray(v) for key, v in batch.items()})
            torch.nn.functional.dropout = ShardDropouts(cell.seed, k, dev,
                                                        batch["xs"].shape[0], (rank,))
            losses.append(float(parallel.global_sum(trainer.train_step(to_device(batch, dev)))))
            if k == 0:
                g1 = train.leaf_norms(parallel.global_sum_(tx.acc.clone(), "state"),
                                      trainer.named_params)
    finally:
        torch.nn.functional.dropout = real_dropout
    change = train.leaf_norms(torch.cat([p.detach().reshape(-1) for p in trainer.params])
                              - start, trainer.named_params)
    del start

    # ---- warm-up: the rest of the loader's first epoch, every shape once
    seen = {fam.shape_key(b) for b in checked}
    shapes = fam.shape_keys(ds, cfg)
    while not shapes <= seen:
        batch = next(loader)
        seen.add(fam.shape_key(batch))
        trainer.train_step(to_device(batch, dev))
    train.sync(dev)
    skipped0 = int(tx.notfinite_count)
    dist.barrier(group=flags)
    setup_s = time.perf_counter() - cell.t_start

    # ---- the window, closed loop, ended at an update's boundary by rank 0's clock
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_losses, records, wait, ends = [], [], 0.0, []
    stop = torch.zeros(1)
    t0 = time.perf_counter()
    while True:
        if len(step_losses) % accum == 0:
            stop[0] = float(rank == 0 and time.perf_counter() - t0 >= cell.seconds)
            dist.all_reduce(stop, group=flags)
            if stop[0] > 0:
                break
        ta = time.perf_counter()
        batch = next(loader)
        dbatch = to_device(batch, dev)
        wait += time.perf_counter() - ta
        step_losses.append(trainer.train_step(dbatch))
        records.append(fam.record(batch))
        ends.append(time.perf_counter())
    train.sync(dev)
    window_s = time.perf_counter() - t0
    if rank == 0:
        train.print_pace(np.diff([t0] + ends), window_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    skipped = int(tx.notfinite_count) - skipped0
    nonfinite = int((~torch.isfinite(torch.stack(step_losses).float())).sum())
    trace = None
    if cell.trace and rank == 0:
        trace = train.traced(cell, trainer, loader, to_device, fam)
    elif cell.trace:
        for _ in range(int(cell.traffic["trace_steps"])):
            trainer.train_step(to_device(next(loader), dev))
        train.sync(dev)
    loader.close()

    # ---- every rank's counts and checked batches to rank 0
    mine = dict(fam.summarize(records), peak=peak,
                failed=min(len(step_losses), max(nonfinite, skipped * accum)))
    ranks = [None] * world
    dist.all_gather_object(ranks, mine, group=flags)
    shards = [None] * world
    dist.gather_object(checked, shards if rank == 0 else None, dst=0, group=flags)
    if rank != 0:
        return None

    out = harness.Run(attempted=len(step_losses), memory_peak_bytes=max(r["peak"] for r in ranks))
    out.failed = max(r["failed"] for r in ranks)
    out.metrics["setup_s"] = setup_s
    out.metrics["train_audio_s_per_s"] = sum(r["audio_s"] for r in ranks) / window_s
    out.stats.update(steps=len(step_losses), window_s=window_s, input_wait_s=wait,
                     peak_bytes=out.memory_peak_bytes, kind=fam.kind,
                     real_frames=sum(r["real_frames"] for r in ranks),
                     padded_frames=sum(r["padded_frames"] for r in ranks),
                     flops=sum(r["flops"] for r in ranks) / world)
    out.trace = trace
    if trace is not None:
        print(f"tracing: {trace['window_s'] / trace['steps']!r} s a traced micro-step, "
              f"{window_s / len(step_losses)!r} s an untraced one", file=sys.stderr, flush=True)

    program = {"loss": losses, "aux": [{} for _ in losses], "grad": g1, "change": change}
    batches = [{key: np.concatenate([s[k][key] for s in shards]) for key in checked[k]}
               for k in range(accum)]
    return out, program, batches


def main(argv):
    """A rank other than 0: ``<cell file> <rank> <address>``."""
    path, rank, address = argv
    spec = json.loads(Path(path).read_text())
    harness.cache_environment()
    kind = spec.pop("device")
    cell = harness.Cell(**spec)
    cell.t_start = time.perf_counter()
    if kind == "cuda":
        cell.device = torch.device("cuda", int(rank) % torch.cuda.device_count())
        torch.cuda.set_device(cell.device)
    else:
        cell.device = torch.device(kind)
    run_rank(cell, int(rank), cell.chips, address)


if __name__ == "__main__":
    main(sys.argv[1:])
