"""Data parallelism across processes (liteasr_tpu/parallel/mesh.py's dp
axis), one process per device.

The JAX package computes every batch reduction over the global, dp-sharded
batch and lets GSPMD insert the gradient psum. Here each process holds a
row block of the global batch, and the reductions that make a step equal to
the global one are explicit:

* the loss denominators (utterances, tokens, masked frames) are all-reduced
  counts (:func:`global_sum`), so a rank's loss is its share of the global
  loss and the sum of the ranks' losses is the loss on the global batch;
* train-mode BatchNorm all-reduces its statistics and the backward's two
  channel sums (``ops/batch_norm.py``);
* wav2vec 2.0's code usage all-reduces its weighted sum with autograd
  (:func:`global_sum_grad`);
* the optimizer all-reduces its flat gradient once per applied step
  (:func:`global_sum_`), the psum of the accumulated gradient.

Without a process group every reduction here is the identity and launches
nothing. A group of one rank runs the collectives (their values are the
identity), so that the path is the one a larger group takes.
``counts`` tallies the collectives by kind.
"""

import collections
import logging
from typing import List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the collectives issued, by kind: "grad" (the flat gradient), "batch_norm"
# (forward statistics and backward sums), "count" (loss denominators),
# "code_usage" (wav2vec 2.0's weighted code probabilities), "metrics" (the
# logged losses and validation scalars), "gather" (decoded hypotheses); a
# global_sum_grad counts once, though its backward all-reduces again
counts: collections.Counter = collections.Counter()

# a rank's seeds are the run's seed plus its rank times this (mod 2**32), so
# that rank 0 keeps the run's streams and no two ranks share one
RANK_SEED_STRIDE = 0x9E3779B1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_master() -> bool:
    return process_index() == 0


def check_layout(dist_cfg, world: int) -> None:
    """``distributed.dp`` must be -1 or the world size (one process owns one
    device); tensor and sequence parallelism are not ported."""
    dist_cfg = dist_cfg or {}
    tp, sp = (int(dist_cfg.get(a) or 1) for a in ("tp", "sp"))
    if tp > 1 or sp > 1:
        raise NotImplementedError(
            "distributed.tp/sp > 1: tensor and sequence parallelism are the "
            "ROADMAP item \"tensor and sequence parallelism\"")
    dp = int(dist_cfg.get("dp") or -1)
    if dp not in (-1, world):
        raise ValueError(
            f"distributed.dp={dp} with {world} process(es): dp must be -1 or "
            "the number of processes (distributed.num_processes), one device "
            "each")


def distributed_init(dist_cfg, device: Optional[torch.device] = None) -> torch.device:
    """Join the process group that ``distributed.coordinator_address``
    names (``tcp://<address>``, ``num_processes`` ranks, this one
    ``process_id``): NCCL for a CUDA device, gloo for the CPU. Without an
    address nothing changes (one process). Returns the rank's device:
    ``device``, by default ``cuda:<process_id % device count>``. A layout
    the port does not have (:func:`check_layout`), a missing CUDA device or
    a failed init raises."""
    dist_cfg = dist_cfg or {}
    addr = dist_cfg.get("coordinator_address")
    if addr and (dist_cfg.get("num_processes") is None
                 or dist_cfg.get("process_id") is None):
        raise ValueError("distributed.coordinator_address needs "
                         "distributed.num_processes and distributed.process_id")
    world = int(dist_cfg["num_processes"]) if addr else 1
    check_layout(dist_cfg, world)
    rank = int(dist_cfg.get("process_id") or 0)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device=torch.device('cpu') "
                               "(--device cpu) to run on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if not addr:
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                world_size=world, rank=rank)
    except Exception as e:
        raise RuntimeError(f"{backend} process group at tcp://{addr} (rank {rank} "
                           f"of {world}) failed to start: {e}") from e
    logger.info("process group: %s at %s, rank %d of %d on %s", backend, addr,
                rank, world, device)
    return device


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def rank_seed(seed: int, rank: Optional[int] = None) -> int:
    """The seed of a per-rank random stream: ``seed`` on rank 0 (and
    without a group), else offset by the rank."""
    rank = process_index() if rank is None else int(rank)
    if rank == 0:
        return int(seed)
    return (int(seed) + rank * RANK_SEED_STRIDE) % (1 << 32)


def global_sum(*xs: torch.Tensor, kind: str = "count"):
    """The sums over the ranks of the scalars ``xs``, as fp32 and without
    gradient, in one all-reduce; without a group, ``xs`` themselves. Returns
    one tensor for one argument, else a tuple."""
    if not is_initialized():
        return xs[0] if len(xs) == 1 else xs
    buf = torch.stack([x.detach().float().reshape(()) for x in xs])
    counts[kind] += 1
    dist.all_reduce(buf)
    out = buf.unbind(0)
    return out[0] if len(xs) == 1 else out


def global_sum_(x: torch.Tensor, kind: str) -> torch.Tensor:
    """All-reduce ``x`` (sum) in place; the identity without a group."""
    if is_initialized():
        counts[kind] += 1
        dist.all_reduce(x)
    return x


def global_sum_grad(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The sum over the ranks of ``x`` with autograd: the backward
    all-reduces the incoming gradient, so that each rank's inputs receive
    the gradient of the sum of every rank's loss. The identity without a
    group."""
    if not is_initialized():
        return x
    from torch.distributed.nn.functional import all_reduce

    counts[kind] += 1
    return all_reduce(x)


def all_gather_object(obj) -> List:
    """``[obj of rank 0, obj of rank 1, ...]`` on every rank; ``[obj]``
    without a group."""
    if not is_initialized():
        return [obj]
    out = [None] * process_count()
    counts["gather"] += 1
    dist.all_gather_object(out, obj)
    return out
