"""Checkpoint I/O (liteasr_tpu/checkpoint.py; reference
liteasr/utils/checkpoint.py:15-73).

A model checkpoint is one ``model.ep.<N>.pt`` holding the model's
``state_dict`` (``torch.save``). :func:`load_ckpt` also reads the JAX
package's ``model.ep.<N>.msgpack`` (flax's ``{"params", "batch_stats"}``)
through :mod:`liteasr_tpu_torch.bridge`, with a reader of its own for the
part of msgpack that flax writes. With ``inference.model_avg`` it averages
the last N checkpoints, or the N best by the ``valid loss:`` lines of
``train.log``, as the JAX package does.

The training state (``train_state.pt`` and its ``.meta``) is written and
read by :class:`liteasr_tpu_torch.trainer.Trainer`.
"""

import glob
import logging
import os
import re
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

CKPT_TEMPLATE = "model.ep.{}.pt"
_CKPT_RE = re.compile(r"model\.ep\.(\d+)\.(pt|msgpack)$")


# ------------------------------------------------- flax msgpack reader

_NDARRAY_EXT, _NPSCALAR_EXT = 1, 3  # flax.serialization._MsgpackExtType


class _Reader:
    """Decoder for the msgpack subset ``flax.serialization`` writes: maps,
    arrays, strings, bytes, ints, floats, bools, nil and flax's ndarray
    ext type."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _ext(self, code: int, n: int):
        data = bytes(self._take(n))
        if code in (_NDARRAY_EXT, _NPSCALAR_EXT):
            arr = _ndarray_from_bytes(data)
            return arr[()] if code == _NPSCALAR_EXT else arr
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: "B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self._take(self._unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack("b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self._unpack("b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.read() for _ in range(self._unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a packed (shape, dtype name, buffer);
    bfloat16 widens to float32 exactly (numpy has no bfloat16)."""
    shape, dtype, buf = _Reader(data, raw=True).read()
    dtype = dtype.decode()
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _unchunk(tree):
    """flax's chunked form of arrays above 1 GiB, back to one array."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore`` without flax or msgpack."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


# ------------------------------------------------------ model checkpoints


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """One checkpoint as the port's state_dict: a ``.pt`` as saved, a JAX
    ``.msgpack`` mapped through the bridge."""
    if path.endswith(".msgpack"):
        from liteasr_tpu_torch.bridge import flax_to_state_dict

        with open(path, "rb") as f:
            return flax_to_state_dict(msgpack_restore(f.read()))
    return torch.load(path, map_location="cpu", weights_only=True)


def _average_params(paths: List[str]) -> Dict[str, torch.Tensor]:
    """Sum in file order in each leaf's dtype; float leaves are divided by
    N, integer leaves integer-divided (liteasr_tpu/checkpoint.py:41-56)."""
    acc = None
    for path in paths:
        sd = load_params(path)
        if acc is None:
            acc = {k: v.clone() for k, v in sd.items()}
        else:
            if set(sd) != set(acc):
                raise ValueError(f"{path} holds other tensors than {paths[0]}")
            for k, v in sd.items():
                acc[k] += v
    n = len(paths)
    return {k: v / n if v.is_floating_point() else torch.div(v, n, rounding_mode="floor")
            for k, v in acc.items()}


_LOSS_RE = (r"valid loss: "
            r"([-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+|nan|inf))")


def parse_valid_losses(log_path: str) -> List[float]:
    """Every ``valid loss: X`` of train.log, in file order (negative,
    scientific, nan and inf included)."""
    pattern = re.compile(_LOSS_RE)
    with open(log_path) as log:
        return [float(m.group(1)) for m in map(pattern.search, log) if m]


def parse_valid_history(log_path: str) -> List[tuple]:
    """``(epoch, valid loss)`` pairs from the trainer's ``... E / MAX epochs
    - valid loss: X`` lines, in file order (a resumed run's repeats kept)."""
    pattern = re.compile(r"(\d+) / (?:\d+|inf) epochs - " + _LOSS_RE)
    with open(log_path) as log:
        return [(int(m.group(1)), float(m.group(2)))
                for m in map(pattern.search, log) if m]


def _ckpt_epoch(path: str) -> int:
    match = _CKPT_RE.search(path)
    return int(match.group(1)) if match else -1


def _loss_for_epoch(history: List[tuple], epoch: int) -> float:
    """The last valid loss logged at an epoch <= ``epoch``: the save
    trigger fires after the valid trigger at the same boundary."""
    best = float("nan")
    for ep, loss in history:
        if ep <= epoch:
            best = loss
    return best


def _model_ckpts(ckpt_path: str) -> Dict[int, str]:
    """epoch -> model checkpoint in ``ckpt_path`` (``.pt`` over a JAX
    ``.msgpack`` of the same epoch); train-state files are not listed."""
    found: Dict[int, str] = {}
    for path in sorted(glob.glob(os.path.join(ckpt_path, "model.ep.*"))):
        match = _CKPT_RE.search(path)
        if match and (match.group(2) == "pt" or int(match.group(1)) not in found):
            found[int(match.group(1))] = path
    return found


def pick_checkpoints(infer_cfg) -> List[str]:
    """The checkpoints ``load_ckpt`` loads: ``ckpt_name``'s alone, or with
    ``model_avg`` the ``avg_num`` last up to it (no ``avg_policy`` log) or
    the ``avg_num`` best by valid loss (liteasr_tpu/checkpoint.py:118-172).
    Checkpoints are in epoch order, not mtime order."""
    found = _model_ckpts(infer_cfg.ckpt_path)
    epoch = int(infer_cfg.ckpt_name)
    if epoch not in found:
        raise FileNotFoundError(
            f"no {CKPT_TEMPLATE.format(epoch)} (or .msgpack) in "
            f"{infer_cfg.ckpt_path}")
    if not infer_cfg.get("model_avg"):
        return [found[epoch]]
    ckpts = [found[e] for e in sorted(found)]
    pos = ckpts.index(found[epoch])
    avg_num = int(infer_cfg.get("avg_num", 1))
    if avg_num < 1 or pos - avg_num + 1 < 0:
        raise ValueError(f"avg_num={avg_num}: only {pos + 1} checkpoints up to "
                         f"epoch {epoch} in {infer_cfg.ckpt_path}")

    avg_policy: Optional[str] = infer_cfg.get("avg_policy")
    if avg_policy and os.path.isdir(avg_policy):
        avg_policy = os.path.join(avg_policy, "train.log")
    if avg_policy is None or not os.path.isfile(avg_policy):
        return ckpts[pos - avg_num + 1: pos + 1]
    history = parse_valid_history(avg_policy)
    if history:  # losses keyed by each checkpoint's epoch
        losses = [_loss_for_epoch(history, _ckpt_epoch(c)) for c in ckpts[: pos + 1]]
    else:  # a log without epoch markers: positional
        losses = parse_valid_losses(avg_policy)
        if len(losses) != pos + 1:
            logger.warning(
                "avg_policy log has %d valid entries for %d checkpoints "
                "and no epoch markers; N-best selection may misalign",
                len(losses), pos + 1)
    # nan losses sort last, so diverged epochs never enter the average
    ranked = sorted(zip(ckpts[: pos + 1], losses[: pos + 1]),
                    key=lambda cl: (np.isnan(cl[1]), cl[1]))[:avg_num]
    check_avg_spread([loss for _, loss in ranked])
    return [c for c, _ in ranked]


def load_ckpt(infer_cfg) -> Dict[str, torch.Tensor]:
    """The (possibly averaged) model state_dict for decoding, on the CPU."""
    paths = pick_checkpoints(infer_cfg)
    if not infer_cfg.get("model_avg"):
        logger.info("loading checkpoint: %s", paths[0])
        return load_params(paths[0])
    logger.info("loading average checkpoint from:\n\t%s", "\n\t".join(paths))
    return _average_params(paths)


def check_avg_spread(losses: List[float], tol: float = 0.5) -> bool:
    """Warn (and return True) when the picked checkpoints' finite valid
    losses spread by more than ``tol`` of the best: an average across
    oscillating checkpoints can score worse than the single best."""
    vals = np.asarray([v for v in losses if np.isfinite(v)], np.float64)
    if vals.size < 2:
        return False
    rel = float(vals.max() - vals.min()) / max(abs(float(vals.min())), 1e-12)
    if rel > tol:
        logger.warning(
            "N-best checkpoints' valid losses spread %.3g..%.3g (%.0f%% of "
            "best): averaging across oscillating checkpoints can score "
            "worse than the single best — compare with model_avg=false",
            vals.min(), vals.max(), 100.0 * rel)
        return True
    return False
