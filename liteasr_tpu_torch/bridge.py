"""Weight bridge between the JAX package's variable tree and the port's
``state_dict``.

The tree is flax's ``{"params": ..., "batch_stats": ...}`` as nested dicts
of numpy arrays (what ``jax.device_get(model.init(...))`` or a msgpack
checkpoint gives). Module paths are the same on both sides (``encoder/
layer_0/self_attn/linear_q`` is ``encoder.layer_0.self_attn.linear_q``);
only the leaves differ:

* Dense ``kernel`` (in, out) <-> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO <-> Conv2d ``weight`` OIHW, and the 1-D Conv
  ``kernel`` (K, I, O) <-> Conv1d ``weight`` (O, I, K) (the Paraformer
  predictor's ``conv``);
* ``depthwise_conv_kernel`` (K, 1, C) / ``depthwise_conv_bias`` <->
  ``depthwise_conv.weight`` (C, 1, K) / ``depthwise_conv.bias``;
* LayerNorm ``<name>/ln/scale|bias`` <-> ``<name>.weight|bias``;
* BatchNorm ``conv/norm`` ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) <-> ``weight``/``bias``/``running_mean``/``running_var``;
* Embed ``embedding`` <-> Embedding ``weight``;
* ``pos_bias_u``/``pos_bias_v`` (H, Dk), wav2vec 2.0's ``mask_emb`` (D,)
  and quantizer codebook ``vars`` (1, G V, D / G), and every ``bias`` keep
  their name;
* a grouped 1-D Conv ``kernel`` (K, I / groups, O) <-> Conv1d ``weight``
  (O, I / groups, K) by the 1-D rule (wav2vec 2.0's ``pos_conv``), and the
  conv feature extractor's LayerNorms ``ln_<i>`` like any other.

Every leaf maps to exactly one tensor, in both directions, with one
exception: an LSTM layer's ``cell`` (flax's ``OptimizedLSTMCell``) holds
twelve leaves, ``{ii,if,ig,io}/kernel`` (in, H), ``{hi,hf,hg,ho}/kernel``
(H, H) and ``{hi,hf,hg,ho}/bias``, which become the port's three packed
tensors ``weight_ih`` (4H, in), ``weight_hh`` (4H, H) and ``bias`` (4H,):
the gates concatenated in i, f, g, o order, the kernels transposed.
"""

import re
from typing import Dict

import numpy as np
import torch

_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_KEEP = ("bias", "pos_bias_u", "pos_bias_v", "mask_emb", "vars")
_BN_STATS_INV = {v: k for k, v in _BN_STATS.items()}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if path[-1] in tree:
        raise ValueError(f"two tensors map to {'/'.join(path)}")
    tree[path[-1]] = value


_GATES = "ifgo"
_LSTM_PACKED = {"weight_ih": ("i", "kernel"), "weight_hh": ("h", "kernel"),
                "bias": ("h", "bias")}


def _lstm_leaf(path) -> bool:
    return len(path) >= 3 and path[-3] == "cell" and path[-2] in (
        [f"i{g}" for g in _GATES] + [f"h{g}" for g in _GATES])


def _pack_lstm(cell_leaves: dict):
    """{cell path: {(gate module, leaf): array}} -> [(torch key, array)]."""
    for cell, leaves in cell_leaves.items():
        for name, (side, leaf) in _LSTM_PACKED.items():
            parts = [leaves[(f"{side}{g}", leaf)] for g in _GATES]
            arr = np.concatenate([p.T if leaf == "kernel" else p for p in parts], axis=0)
            yield ".".join(cell + (name,)), arr


def _unpack_lstm(mods, name, arr):
    """One packed tensor of a cell -> [(flax path, array)]."""
    side, leaf = _LSTM_PACKED[name]
    for g, part in zip(_GATES, np.split(arr, 4, axis=0)):
        yield tuple(mods) + (f"{side}{g}", leaf), part.T if leaf == "kernel" else part


def _leaf_to_torch(path, arr):
    """One flax leaf (path without the collection) -> (torch key, array)."""
    *mods, leaf = path
    if len(mods) >= 1 and mods[-1] == "ln":  # LayerNorm
        mods = mods[:-1]
        name = {"scale": "weight", "bias": "bias"}[leaf]
    elif leaf == "kernel" and arr.ndim == 2:
        name, arr = "weight", arr.T
    elif leaf == "kernel" and arr.ndim == 3:
        name, arr = "weight", arr.transpose(2, 1, 0)
    elif leaf == "kernel" and arr.ndim == 4:
        name, arr = "weight", arr.transpose(3, 2, 0, 1)
    elif leaf == "depthwise_conv_kernel":
        mods, name, arr = mods + ["depthwise_conv"], "weight", arr.transpose(2, 1, 0)
    elif leaf == "depthwise_conv_bias":
        mods, name = mods + ["depthwise_conv"], "bias"
    elif leaf == "scale":  # BatchNorm
        name = "weight"
    elif leaf == "embedding":
        name = "weight"
    elif leaf in _KEEP:
        name = leaf
    else:
        raise ValueError(f"unknown flax leaf {'/'.join(path)}")
    return ".".join(mods + [name]), arr


def flax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """flax variables (params [+ batch_stats]) -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))

    cells: dict = {}
    for collection, tree in variables.items():
        for path, arr in _flatten(tree):
            if collection == "params" and _lstm_leaf(path):
                cells.setdefault(path[:-2], {})[path[-2:]] = np.asarray(arr)
            elif collection == "params":
                put(*_leaf_to_torch(path, np.asarray(arr)))
            elif collection == "batch_stats" and path[-1] in _BN_STATS:
                put(".".join(path[:-1] + (_BN_STATS[path[-1]],)), arr)
            else:
                raise ValueError(f"unknown flax variable {collection}/{'/'.join(path)}")
    for key, arr in _pack_lstm(cells):
        put(key, arr)
    return out


def flax_to_shard(variables, rank: int, tp: int) -> Dict[str, torch.Tensor]:
    """flax variables -> tp rank ``rank``'s shard of the torch state_dict
    (``parallel.sharding``'s rules): a JAX checkpoint loads straight into a
    tensor-parallel run."""
    from liteasr_tpu_torch.parallel.sharding import shard_state_dict

    return shard_state_dict(flax_to_state_dict(variables), rank, tp)


def state_dict_to_flax(state_dict) -> dict:
    """torch state_dict -> flax variables {"params", "batch_stats"} of numpy
    arrays (the inverse of :func:`flax_to_state_dict`)."""
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        *mods, name = key.split(".")
        parent = mods[-1] if mods else ""
        if parent == "cell" and name in _LSTM_PACKED:
            for path, part in _unpack_lstm(mods, name, arr):
                _set(variables["params"], path, np.ascontiguousarray(part))
            continue
        if name in _BN_STATS_INV:
            _set(variables["batch_stats"], tuple(mods) + (_BN_STATS_INV[name],), arr)
            continue
        if parent == "depthwise_conv":
            mods = mods[:-1]
            if name == "weight":
                name, arr = "depthwise_conv_kernel", arr.transpose(2, 1, 0)
            else:
                name = "depthwise_conv_bias"
        elif parent == "norm":  # BatchNorm
            name = {"weight": "scale", "bias": "bias"}[name]
        elif parent.endswith("norm") or re.fullmatch(r"ln_\d+", parent):  # LayerNorm
            mods = mods + ["ln"]
            name = {"weight": "scale", "bias": "bias"}[name]
        elif name == "weight" and parent == "embed" and arr.ndim == 2:
            name = "embedding"
        elif name == "weight" and arr.ndim == 2:
            name, arr = "kernel", arr.T
        elif name == "weight" and arr.ndim == 3:
            name, arr = "kernel", arr.transpose(2, 1, 0)
        elif name == "weight" and arr.ndim == 4:
            name, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif name not in _KEEP:
            raise ValueError(f"unknown torch tensor {key}")
        _set(variables["params"], tuple(mods) + (name,), np.ascontiguousarray(arr))
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return variables
