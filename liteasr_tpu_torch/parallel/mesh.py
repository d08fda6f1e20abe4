"""Data, sequence and tensor parallelism across processes
(liteasr_tpu/parallel/mesh.py's ('dp', 'sp', 'tp') mesh), one process per
device.

The ranks form the JAX mesh's layout with tp innermost: rank = (dp_i sp +
sp_i) tp + tp_i (:class:`Layout`). Every rank creates, in the same order,
the process groups of its tp peers (the same dp_i and sp_i), its sp peers
(the same dp_i and tp_i), its dp peers (the same sp_i and tp_i) and its
dp x sp peers (the same tp_i) (:func:`init_groups`); with tp = sp = 1 the
dp and dp x sp groups are the world, and a tp or sp group of one rank runs
no collective. Every reduction below names its group: a batch reduction
sums the dp peers (tp and sp peers hold the same rows), a gradient or a
BatchNorm statistic the dp x sp peers (each holds a share of the frames or
rows), and :mod:`.sharding` builds Megatron's tp and the sp gathers on the
same groups.

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
``counts`` tallies the collectives by kind, and by group where the group is
not a data group: ``"<kind>@tp"``, ``"<kind>@sp"``.

Tensors move by ``all_reduce`` and ``all_gather`` only, which NCCL and
gloo, on CPU and CUDA tensors alike, both have; host objects by
``all_gather_object``.
"""

import collections
import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the collectives issued, by kind: "grad" (the flat gradient), "batch_norm"
# (forward statistics and backward sums), "count" (loss denominators),
# "code_usage" (wav2vec 2.0's weighted code probabilities), "metrics" (the
# logged losses and validation scalars), "gather" (decoded hypotheses),
# "state" (a train state's partial gradient accumulation; over the tp group,
# the shards a checkpoint gathers); a global_sum_grad counts once, though
# its backward all-reduces again
counts: collections.Counter = collections.Counter()

# a rank's seeds are the run's seed plus its rank times this (mod 2**32), so
# that rank 0 keeps the run's streams and no two ranks share one
RANK_SEED_STRIDE = 0x9E3779B1


@dataclasses.dataclass(frozen=True)
class Layout:
    """The mesh ('dp', 'sp', 'tp') and this rank's coordinates in it."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    dp_i: int = 0
    sp_i: int = 0
    tp_i: int = 0

    @classmethod
    def of_rank(cls, rank: int, dp: int, sp: int, tp: int) -> "Layout":
        return cls(dp, sp, tp, rank // (sp * tp), rank // tp % sp, rank % tp)

    def rank(self, dp_i: int, sp_i: int, tp_i: int) -> int:
        return (dp_i * self.sp + sp_i) * self.tp + tp_i


_LAYOUT = Layout()
# group name -> the ProcessGroup (None: the world); "tp", "sp", "dp", "dpsp"
_GROUPS: Dict[str, Optional[object]] = {}
# the kinds counted under their own name: reductions over a data group
_DATA_GROUPS = ("dp", "dpsp")


def layout() -> Layout:
    return _LAYOUT


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_master() -> bool:
    return process_index() == 0


def check_layout(dist_cfg, world: int) -> Layout:
    """The (dp, sp, tp) layout of ``world`` processes, one device each:
    ``distributed.dp`` x ``sp`` x ``tp`` must be the number of processes
    (``dp`` -1: the rest of it, as the JAX package's ``get_mesh``). Returns
    the layout, with rank 0's coordinates."""
    dist_cfg = dist_cfg or {}
    tp, sp = (int(dist_cfg.get(a) or 1) for a in ("tp", "sp"))
    if tp < 1 or sp < 1:
        raise ValueError(f"distributed.tp={tp}, sp={sp}: each must be >= 1")
    dp = int(dist_cfg.get("dp") or -1)
    if dp == -1 and world % (tp * sp) == 0:
        dp = world // (tp * sp)
    if dp * sp * tp != world:
        raise ValueError(
            f"distributed.dp={dist_cfg.get('dp')} x sp={sp} x tp={tp} with {world} "
            "process(es): dp must be -1 or the number of processes over sp x tp "
            "(distributed.num_processes, one device each)")
    return Layout(dp, sp, tp)


def init_groups(lay: Layout) -> None:
    """Set the run's layout and create its process groups, on every rank in
    the same order (``new_group`` is a collective): for each tp group (dp_i,
    sp_i), each sp group (dp_i, tp_i), each dp group (sp_i, tp_i), each dp x
    sp group (tp_i). With tp = sp = 1 no group is created: dp and dp x sp
    are the world."""
    global _LAYOUT
    _LAYOUT = lay
    _GROUPS.clear()
    if lay.tp == lay.sp == 1:
        return
    me = lay.rank(lay.dp_i, lay.sp_i, lay.tp_i)
    ranges = {
        "tp": [[lay.rank(d, s, t) for t in range(lay.tp)]
               for d in range(lay.dp) for s in range(lay.sp)],
        "sp": [[lay.rank(d, s, t) for s in range(lay.sp)]
               for d in range(lay.dp) for t in range(lay.tp)],
        "dp": [[lay.rank(d, s, t) for d in range(lay.dp)]
               for s in range(lay.sp) for t in range(lay.tp)],
        "dpsp": [[lay.rank(d, s, t) for d in range(lay.dp) for s in range(lay.sp)]
                 for t in range(lay.tp)],
    }
    for name, groups in ranges.items():
        for ranks in groups:
            g = dist.new_group(ranks)
            if me in ranks:
                _GROUPS[name] = g


def group(name: str):
    """The process group ``name`` ("tp", "sp", "dp" or "dpsp"); None is the
    world."""
    return _GROUPS.get(name)


def tally(kind: str, name: str) -> None:
    """Count one collective of ``kind`` over group ``name`` in ``counts``."""
    counts[kind if name in _DATA_GROUPS else f"{kind}@{name}"] += 1


def _reduces(name: str) -> bool:
    """Whether a reduction over group ``name`` runs a collective: under a
    process group, for a data group always (a one-rank world included), for
    a tp or sp group when it has more than one rank."""
    if not is_initialized():
        return False
    return name in _DATA_GROUPS or getattr(_LAYOUT, name) > 1


def distributed_init(dist_cfg, device: Optional[torch.device] = None) -> torch.device:
    """Join the process group that ``distributed.coordinator_address``
    names (``tcp://<address>``, ``num_processes`` ranks, this one
    ``process_id``): NCCL for a CUDA device, gloo for the CPU. Without an
    address nothing changes (one process). Returns the rank's device:
    ``device``, by default ``cuda:<process_id % device count>``. A default
    group that the caller has started already (say gloo over CUDA tensors,
    for ranks that share a device, which NCCL refuses) is joined as it is,
    if its world size and rank are the config's. A layout the port does not
    have (:func:`check_layout`), a missing CUDA device or a failed init
    raises."""
    dist_cfg = dist_cfg or {}
    addr = dist_cfg.get("coordinator_address")
    if addr and (dist_cfg.get("num_processes") is None
                 or dist_cfg.get("process_id") is None):
        raise ValueError("distributed.coordinator_address needs "
                         "distributed.num_processes and distributed.process_id")
    world = int(dist_cfg["num_processes"]) if addr else 1
    lay = check_layout(dist_cfg, world)
    rank = int(dist_cfg.get("process_id") or 0)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device=torch.device('cpu') "
                               "(--device cpu) to run on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if not addr:
        init_groups(Layout())
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if is_initialized():  # the caller's group
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise ValueError(f"the process group holds rank {dist.get_rank()} of "
                             f"{dist.get_world_size()}, the config rank {rank} of {world}")
        backend = dist.get_backend()
    else:
        try:
            dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                    world_size=world, rank=rank)
        except Exception as e:
            raise RuntimeError(f"{backend} process group at tcp://{addr} (rank {rank} "
                               f"of {world}) failed to start: {e}") from e
    init_groups(Layout.of_rank(rank, lay.dp, lay.sp, lay.tp))
    logger.info("process group: %s at %s, rank %d of %d on %s (dp %d x sp %d x tp %d)",
                backend, addr, rank, world, device, lay.dp, lay.sp, lay.tp)
    return device


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()
    init_groups(Layout())


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def rank_seed(seed: int, rank: Optional[int] = None) -> int:
    """The seed of a per-rank random stream: ``seed`` on rank 0 (and
    without a group), else offset by ``rank`` (by default the process's; a
    stream keyed by coordinates passes their index, e.g. ``dp_i`` for a
    draw that tp and sp peers share)."""
    rank = process_index() if rank is None else int(rank)
    if rank == 0:
        return int(seed)
    return (int(seed) + rank * RANK_SEED_STRIDE) % (1 << 32)


def global_sum(*xs: torch.Tensor, kind: str = "count", over: str = "dp"):
    """The sums over the ``over`` group (by default the dp peers: the
    batch's rows) of the scalars ``xs``, as fp32 and without gradient, in
    one all-reduce; without a group, ``xs`` themselves. Returns one tensor
    for one argument, else a tuple."""
    if not _reduces(over):
        return xs[0] if len(xs) == 1 else xs
    buf = torch.stack([x.detach().float().reshape(()) for x in xs])
    tally(kind, over)
    dist.all_reduce(buf, group=group(over))
    out = buf.unbind(0)
    return out[0] if len(xs) == 1 else out


def global_sum_(x: torch.Tensor, kind: str, over: str = "dpsp") -> torch.Tensor:
    """All-reduce ``x`` (sum) in place over the ``over`` group (by default
    the dp x sp peers, which hold the shares of a gradient); the identity
    without a group."""
    if _reduces(over):
        tally(kind, over)
        dist.all_reduce(x, group=group(over))
    return x


def global_sum_grad(x: torch.Tensor, kind: str, over: str = "dp") -> torch.Tensor:
    """The sum over the ``over`` group of ``x`` with autograd: the backward
    all-reduces the incoming gradient, so that each rank's inputs receive
    the gradient of the sum of every rank's loss. The identity without a
    group."""
    if not _reduces(over):
        return x
    from torch.distributed.nn.functional import all_reduce

    tally(kind, over)
    return all_reduce(x, group=group(over) or dist.group.WORLD)


# random streams keyed by coordinate, seeded by the train CLI
# (:func:`seed_streams`): "tp" draws the dropout inside a tp-sharded region
# (every rank its own), "dp" the dropout of an activation that the tp and
# sp peers of a dp rank all hold whole (the rel-pos table under sp)
STREAM_SALTS = {"tp": 0x5EED7A01, "dp": 0x5EED0D01}
_STREAMS: Dict[Tuple[str, str], torch.Generator] = {}
_STREAM_SEED = [0]


def _stream_index(name: str) -> int:
    return process_index() if name == "tp" else _LAYOUT.dp_i


def seed_streams(seed: int) -> None:
    """(Re)seed the coordinate-keyed streams of the run's ``seed``."""
    _STREAM_SEED[0] = int(seed)
    _STREAMS.clear()


def stream(name: str, device) -> torch.Generator:
    """The ``name`` stream's generator on ``device`` (made on first use)."""
    device = torch.device(device)
    key = (name, str(device))
    if key not in _STREAMS:
        g = torch.Generator(device=device)
        g.manual_seed(rank_seed(_STREAM_SEED[0] ^ STREAM_SALTS[name], _stream_index(name)))
        _STREAMS[key] = g
    return _STREAMS[key]


def stream_states(device=None) -> Dict[Tuple[str, str], torch.Tensor]:
    """The states of the streams made so far; with ``device``, every named
    stream on it is made first, so that the states also cover the streams
    whose first draw is still to come."""
    if device is not None:
        for name in STREAM_SALTS:
            stream(name, device)
    return {key: g.get_state() for key, g in _STREAMS.items()}


def set_stream_states(states: Dict[Tuple[str, str], torch.Tensor]) -> None:
    for (name, device), state in states.items():
        stream(name, device).set_state(state)


def all_gather_object(obj) -> List:
    """``[obj of rank 0, obj of rank 1, ...]`` on every rank; ``[obj]``
    without a group."""
    if not is_initialized():
        return [obj]
    out = [None] * process_count()
    counts["gather"] += 1
    dist.all_gather_object(out, obj)
    return out
