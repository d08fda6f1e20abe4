"""Model export: serialized ``torch.export`` decode and forward programs
(liteasr_tpu/export.py).

``torch.export`` traces the decode pipeline (``decode.decode_pipeline``,
the function that the live decode runs) at one padded bucket into an
``ExportedProgram``, saved with ``torch.export.save`` into bytes. K1 stays
one node of the graph for each of its calls, the op
``liteasr::rel_attention_fwd`` (``ops/flash_attention.py``): on the card it
launches the hand-written kernel, on the CPU the plain version.

As in the JAX package, the parameters stay inputs, not constants of the
artifact: the program takes the model's state dict, so another checkpoint
(an average, a later epoch) runs without a new export.

Two differences from JAX's StableHLO artifact: the program is traced on one
device (``platforms``: ``cpu``, or ``cuda``/``gpu``; :func:`load_exported`
moves it to another with ``torch.export.passes.move_to_device_pass``), and
loading it needs the op registered, that is this package's
``ops.flash_attention`` imported (:func:`load_exported` does it), where
JAX's artifact needs no model code.

Usage::

    blob = export_decode(model, model.state_dict(), mode="attention_rescore",
                         batch=16, frames=1600, feat_dim=80)
    run = load_exported(blob)
    hyps, lens = run(state_dict, xs, xlens)
"""

import io
import json
from typing import Callable, Dict, Optional, Sequence

import torch

MANIFEST = "liteasr.json"  # the program's extra file: the state dict's keys


def _device(platforms) -> torch.device:
    """The device a program is traced on: ``platforms`` (a name or a
    sequence of one) as ``cpu`` or ``cuda``/``gpu``; None: the first GPU."""
    if platforms is None:
        return torch.device("cuda", 0)
    names = [platforms] if isinstance(platforms, str) else list(platforms)
    if len(names) != 1:
        raise ValueError(f"export.platforms={names}: a program is traced on one device "
                         "(cpu or cuda); load_exported moves it to another")
    name = names[0].lower()
    if name in ("gpu", "cuda"):
        return torch.device("cuda", 0)
    if name != "cpu":
        raise ValueError(f"export.platforms: unknown platform {name!r}")
    return torch.device("cpu")


class _Call(torch.nn.Module):
    """``fn(*args)``, which reads ``model``'s parameters and buffers, as a
    module whose state is the model's (under ``model.``), so that
    ``torch.func.functional_call`` runs it at another state dict."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Program(torch.nn.Module):
    """``(state, *args) -> fn(*args)`` at ``state``, the module that
    ``torch.export`` traces. The call is held outside the module tree, so
    that none of the model's tensors becomes a parameter of the program."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self._call = (_Call(model, fn),)

    def forward(self, state: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(
            self._call[0], {f"model.{k}": v for k, v in state.items()}, args, strict=True)


def export_fn(model: torch.nn.Module, fn: Callable, state: Dict[str, torch.Tensor],
              *example_args, platforms=None) -> bytes:
    """Serialize ``fn(*args)``, which reads ``model``'s parameters and
    buffers, as a program of ``(state, *args)`` traced at the example
    arguments' shapes and dtypes on the ``platforms`` device."""
    from liteasr_tpu_torch.ops import flash_attention  # noqa: F401  (K1's op)

    dev = _device(platforms)
    state = {k: v.detach().to(dev) for k, v in state.items()}
    args = tuple(a.to(dev) for a in example_args)
    program = _Program(model.to(dev), fn)
    with torch.no_grad():
        ep = torch.export.export(program, (state, *args), strict=False)
    # the example inputs hold a copy of the weights, and each op's Python
    # stack most of the graph's bytes: neither is needed to run
    ep.example_inputs = None
    for node in ep.graph.nodes:
        node.meta.pop("stack_trace", None)
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={MANIFEST: json.dumps({"keys": list(state)})})
    return buf.getvalue()


def load_exported(blob: bytes, device: Optional[torch.device] = None) -> Callable:
    """Deserialize a program into ``run(state, *args)``; ``device``: move it
    there first (by default it runs where it was traced)."""
    from liteasr_tpu_torch.ops import flash_attention  # noqa: F401  (K1's op)

    extra = {MANIFEST: ""}
    ep = torch.export.load(io.BytesIO(blob), extra_files=extra)
    keys = json.loads(extra[MANIFEST])["keys"]
    if device is not None:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, torch.device(device))
    module = ep.module()

    def run(state: Dict[str, torch.Tensor], *args):
        with torch.no_grad():
            return module({k: state[k] for k in keys}, *args)

    run.program = ep
    return run


def count_nodes(blob_or_program, target: str = "liteasr.rel_attention_fwd") -> int:
    """The program's call nodes of the op ``target``."""
    ep = blob_or_program
    if isinstance(ep, (bytes, bytearray)):
        ep = torch.export.load(io.BytesIO(ep))
    return sum(1 for n in ep.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(target))


def export_decode(model, state: Dict[str, torch.Tensor], mode: str = "attention_rescore",
                  beam_size: int = 10, ctc_weight: float = 0.5, batch: int = 16,
                  frames: int = 1600, feat_dim: int = 80,
                  platforms: Optional[Sequence[str]] = None) -> bytes:
    """Export one end-to-end U2 decode pipeline at a fixed padded shape
    (``decode.decode_pipeline`` without its early stop); export one
    artifact per serving bucket."""
    from liteasr_tpu_torch.decode import decode_pipeline

    pipeline = decode_pipeline(model, mode, beam_size, ctc_weight, early_stop=False)
    xs = torch.zeros((batch, frames, feat_dim), dtype=torch.float32)
    xlens = torch.full((batch,), frames, dtype=torch.int64)
    return export_fn(model, pipeline, state, xs, xlens, platforms=platforms)


def export_forward(model, state: Dict[str, torch.Tensor], batch: int, frames: int,
                   feat_dim: int, label_len: int, platforms=None) -> bytes:
    """Export the training-mode-off forward (h_attn, h_ctc) at a fixed shape."""

    def fwd(xs, xlens, ys, ylens):
        return model(xs, xlens, ys, ylens, train=False)

    return export_fn(
        model, fwd, state,
        torch.zeros((batch, frames, feat_dim), dtype=torch.float32),
        torch.full((batch,), frames, dtype=torch.int64),
        torch.zeros((batch, label_len), dtype=torch.int64),
        torch.full((batch,), label_len, dtype=torch.int64),
        platforms=platforms)


def main(argv=None):
    """Export CLI, the --config-dir flow of the infer CLI::

        python -m liteasr_tpu_torch.export --config-dir exp/u2 \\
            inference.ckpt_name=100 inference.model_avg=true \\
            export.out=exp/u2/attention_rescore_16x1600.pt2 \\
            export.mode=attention_rescore export.batch=16 export.frames=1600

    Writes the program and, beside it, ``<out>.json`` with its mode, bucket
    and size. ``export.platforms`` names the device it is traced on (cpu,
    or cuda/gpu: the default)."""
    import logging
    import os
    import sys

    from liteasr_tpu_torch import tasks
    from liteasr_tpu_torch.checkpoint import load_ckpt
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml
    from liteasr_tpu_torch.train import setup_logging

    args = list(argv if argv is not None else sys.argv[1:])
    config_dir = None
    if "--config-dir" in args:
        i = args.index("--config-dir")
        config_dir = args[i + 1]
        del args[i:i + 2]
    exp_over = {}
    rest = []
    for a in args:  # export.* keys are CLI-only (not part of the schema)
        if a.startswith("export."):
            k, _, v = a.partition("=")
            exp_over[k.split(".", 1)[1]] = v
        else:
            rest.append(a)
    base = load_yaml(os.path.join(config_dir, "config.yaml")) if config_dir else None
    cfg = compose(rest, base=base)
    setup_logging(cfg.common.run_dir, cfg.common.log_level, filename="export.log")
    logger = logging.getLogger(__name__)

    task = tasks.setup_task(cfg.task)
    # resolve the feature dim before building: a training run persists
    # input_dim unresolved (the task probes it from data), so take
    # export.feat_dim or probe the test set as infer does
    if "feat_dim" in exp_over:
        cfg.model.input_dim = int(exp_over["feat_dim"])
    elif not isinstance(cfg.model.get("input_dim"), int):
        task.load_dataset("test", list(task.cfg.test), cfg.dataset, None)
        cfg.model.input_dim = task.feat_dim
    model = task.build_model(cfg.model)
    state = load_ckpt(cfg.inference)

    mode = exp_over.get("mode", "attention_rescore")
    batch = int(exp_over.get("batch", 16))
    frames = int(exp_over.get("frames", 1600))
    feat_dim = int(cfg.model.input_dim)
    out = exp_over.get("out") or os.path.join(cfg.common.run_dir,
                                              f"{mode}_{batch}x{frames}.pt2")
    platforms = (tuple(exp_over["platforms"].split(",")) if "platforms" in exp_over
                 else None)

    blob = export_decode(model, state, mode=mode, batch=batch, frames=frames,
                         feat_dim=feat_dim, platforms=platforms)
    with open(out, "wb") as f:
        f.write(blob)
    with open(out + ".json", "w") as f:
        json.dump({"mode": mode, "batch": batch, "frames": frames,
                   "feat_dim": feat_dim, "bytes": len(blob)}, f)
    logger.info("exported %s (%.1f MB) -> %s", mode, len(blob) / 1e6, out)
    return out


if __name__ == "__main__":
    main()
