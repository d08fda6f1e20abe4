"""Subprocess worker of the port's data-parallel tests (imports no JAX).

    python tests/torch_dp_worker.py reductions ADDR WORLD RANK OUT
    python tests/torch_dp_worker.py train INIT_STATE_DICT OVERRIDES...
    python tests/torch_dp_worker.py decode OUT OVERRIDES...

``reductions``: joins a gloo group and runs every case of :data:`CASES` on
its row block of the case's global batch (:func:`run_case`), saving the
results to OUT. ``train``: ``liteasr_tpu_torch.train.main`` on the CPU, the
model starting from INIT_STATE_DICT (``-`` for the seeded init). ``decode``:
joins the group that the overrides' ``distributed.*`` name and runs
``infer.infer`` on the CPU, writing the results as JSON to OUT. The test
process imports this module too, for the one-process references.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)
sys.path.insert(0, REPO)

CPU = torch.device("cpu")
CASES = ("batch_norm", "rel_attention_dropout", "hybrid_ctc", "hybrid_ctc_dummy_rank",
         "rnnt", "paraformer", "wav2vec")
B = 4  # rows of every case's global batch
U2_TINY = dict(input_dim=16, vocab_size=30, enc_dim=32, enc_ff_dim=64,
               enc_attn_heads=4, enc_layers=2, dec_dim=32, dec_ff_dim=64,
               dec_attn_heads=4, dec_layers=1)
TD_TINY = dict(input_dim=16, vocab_size=12, joint_dim=24, enc_arch="conformer",
               enc_dim=32, enc_ff_dim=64, enc_attn_heads=4, enc_layers=2, dec_dim=16,
               dec_units=20, dec_layers=2)
PARA_TINY = dict(input_dim=16, vocab_size=12, enc_dim=32, enc_ff_dim=64,
                 enc_attn_heads=2, enc_layers=2, dec_dim=32, dec_ff_dim=64,
                 dec_attn_heads=2, dec_layers=1)
W2V_TINY = dict(encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                encoder_attention_heads=2,
                conv_feature_layers="[(32, 10, 5), (32, 8, 4), (32, 4, 2)]",
                latent_vars=8, latent_groups=2, num_negatives=4, mask_length=3,
                mask_prob=0.5, conv_pos=4, conv_pos_groups=2, dropout=0.0,
                attention_dropout=0.0)


def asr_batch(seed: int, vocab: int, dummy_rows=()):
    """(B, 57, 16) features with ragged lengths and labels; ``dummy_rows``
    are the collator's weight-0 dummy rows (7 frames, no labels)."""
    rng = np.random.default_rng(seed)
    T, F, L = 57, 16, 6
    xs = rng.normal(size=(B, T, F)).astype(np.float32)
    xlens = np.array([T, 44, 30, 51], np.int32)
    ys = rng.integers(1, vocab - 1, size=(B, L)).astype(np.int32)
    ylens = np.array([L, 3, 5, 2], np.int32)
    valid = np.ones(B, np.float32)
    for r in dummy_rows:
        xs[r], xlens[r], ylens[r], valid[r] = 0.0, 7, 0, 0.0
    ys[np.arange(L)[None, :] >= ylens[:, None]] = -1
    return dict(xs=xs, xlens=xlens, ys=ys, ylens=ylens, valid=valid)


def build_case(name):
    """(model, criterion, global numpy batch, hand(model, lo, hi)): ``hand``
    gives the model rows lo:hi of the case's global random draws."""
    from liteasr_tpu_torch.config.core import DotDict

    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    hand = lambda model, lo, hi: None  # noqa: E731
    if name.startswith("hybrid_ctc"):
        from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss
        from liteasr_tpu_torch.models.u2 import U2

        model = U2(**U2_TINY, generator=gen)
        crit = HybridCTCLoss(DotDict(vocab_size=30, padding_idx=-1, smoothing=0.1,
                                     ctc_weight=0.3))
        batch = asr_batch(1, 30, dummy_rows=(2, 3) if name.endswith("dummy_rank") else ())
    elif name == "rnnt":
        from liteasr_tpu_torch.criterions.rnnt import RNNTLoss
        from liteasr_tpu_torch.models.transducer import Transducer

        model = Transducer(**TD_TINY, generator=gen)
        crit = RNNTLoss(DotDict(blank_id=0))
        batch = asr_batch(2, 12)
    elif name == "paraformer":
        from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss
        from liteasr_tpu_torch.models.paraformer import Paraformer

        model = Paraformer(**PARA_TINY, generator=gen)
        crit = ParaformerLoss(DotDict(vocab_size=12, gamma=1.0))
        batch = asr_batch(3, 12)
        noise = torch.rand((B, batch["ys"].shape[1]), generator=gen)

        def hand(model, lo, hi):
            model.draw_glance_noise = lambda b, u, train, device: noise[lo:hi, :u].to(device)
    elif name == "wav2vec":
        from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss
        from liteasr_tpu_torch.models.wav2vec2 import Wav2Vec2
        from liteasr_tpu_torch.nets.wav2vec2 import conv_output_length

        model = Wav2Vec2(**W2V_TINY, generator=gen)
        model.seed_dropout(0)
        crit = Wav2Vec2Loss(DotDict(diversity_weight=1.0))
        rng = np.random.default_rng(4)
        S = 960
        batch = dict(xs=rng.normal(size=(B, S)).astype(np.float32),
                     xlens=np.array([S, 800, 700, 900], np.int32),
                     valid=np.array([1, 1, 1, 0], np.float32))
        F = conv_output_length(S, model.conv_layers)
        flens = model.feature_lengths(torch.from_numpy(batch["xlens"]).long())
        mask = model.draw_mask(B, F, flens, True)
        u = torch.rand((B, F, model.num_negatives), generator=gen)
        g = model.quantizer.groups
        gumbels = model.draw_gumbel_noise(B * F * g, CPU)

        def hand(model, lo, hi):
            model.draw_mask = lambda b, f, fl, train: mask[lo:hi]
            model.draw_negatives_uniform = lambda b, f, train, d: u[lo:hi]
            model.draw_gumbel_noise = lambda n, d: gumbels[lo * F * g:hi * F * g]
    else:
        raise ValueError(name)
    return model, crit, batch, hand


def run_case(name, lo: int = 0, hi: int = B) -> dict:
    """Rows lo:hi of the case's global batch: the train-mode loss, aux and
    every gradient, the buffers after that forward, then the eval-mode loss
    and aux; for ``batch_norm``, TrainBatchNorm's outputs and gradients."""
    from liteasr_tpu_torch.trainer import to_device

    if name == "batch_norm":
        from liteasr_tpu_torch.ops.batch_norm import train_batch_norm

        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.normal(1.0, 2.0, size=(B, 11, 8)).astype(np.float32))
        dy = torch.from_numpy(rng.normal(size=(B, 11, 8)).astype(np.float32))
        gamma = torch.from_numpy(rng.normal(size=8).astype(np.float32))
        beta = torch.from_numpy(rng.normal(size=8).astype(np.float32))
        args = [a.clone().requires_grad_() for a in (x[lo:hi], gamma, beta)]
        y, mean, var = train_batch_norm(*args, 1e-5)
        (y * dy[lo:hi]).sum().backward()
        return dict(y=y.detach(), mean=mean, var=var, dx=args[0].grad,
                    dgamma=args[1].grad, dbeta=args[2].grad)
    if name == "rel_attention_dropout":  # K3's counter-hash dropout, p = 0.3
        from liteasr_tpu_torch.nets.attention import RelativeMultiHeadAttention

        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.normal(size=(B, 9, 16)).astype(np.float32))
        pos = torch.from_numpy(rng.normal(size=(1, 9, 16)).astype(np.float32))
        torch.manual_seed(0)  # the layer's weights
        att = RelativeMultiHeadAttention(16, 2, 0.3)
        att.generator.manual_seed(5)
        with torch.no_grad():
            return dict(y=att(x[lo:hi], x[lo:hi], x[lo:hi], pos, train=True))
    model, crit, batch, hand = build_case(name)
    hand(model, lo, hi)
    part = to_device({k: v[lo:hi] for k, v in batch.items()}, CPU)
    loss, aux = crit(model, dict(part, step=0), train=True)
    loss.backward()
    out = dict(loss=loss.detach(), aux={k: v.detach() for k, v in aux.items()},
               grads={n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
               buffers={n: b.clone() for n, b in model.named_buffers()})
    with torch.no_grad():
        eloss, eaux = crit(model, part, train=False)
    out.update(eval_loss=eloss, eval_aux=dict(eaux))
    return out


def free_address() -> str:
    """127.0.0.1 and a port the OS hands out (bound to 0, then released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def start(commands):
    """Start every command (argv lists) at once, on the CPU, from the repo."""
    import subprocess

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    return [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for cmd in commands]


def wait(proc, timeout: float):
    """(returncode, output) of ``proc``; kills it and raises if it is still
    running after ``timeout`` seconds."""
    import subprocess

    try:
        out = proc.communicate(timeout=max(1.0, timeout))[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"still running after {timeout:.0f} s:\n"
                             + proc.communicate()[0][-3000:])
    return proc.returncode, out


def launch(commands, timeout: float = 180.0):
    """Start every command at once and wait for all, at most ``timeout``
    seconds in all; every process still running then is killed. Returns
    [(returncode, output)]."""
    import time

    procs = start(commands)
    deadline = time.monotonic() + timeout
    try:
        return [wait(p, deadline - time.monotonic()) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def reductions(addr: str, world: int, rank: int, out: str) -> None:
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict

    parallel.distributed_init(DotDict(coordinator_address=addr, num_processes=world,
                                      process_id=rank), CPU)
    rows = B // world
    try:
        results = {name: run_case(name, rank * rows, (rank + 1) * rows) for name in CASES}
        results["counts"] = dict(parallel.counts)
        torch.save(results, out)
    finally:
        parallel.destroy()


def train(init: str, overrides) -> None:
    from liteasr_tpu_torch import train as port_train
    from liteasr_tpu_torch.tasks import LiteasrTask

    if init != "-":
        build = LiteasrTask.build_model

        def build_model(self, cfg, device=None, generator=None):
            model = build(self, cfg, device=device, generator=generator)
            model.load_state_dict(torch.load(init, weights_only=True), strict=True)
            return model

        LiteasrTask.build_model = build_model
    trainer = port_train.main(list(overrides) + ["--device", "cpu"])
    print(f"DP_WORKER_DONE rank={trainer.rank} world={trainer.world} "
          f"step={trainer.step} backend={trainer.backend}", flush=True)


def decode(out: str, overrides) -> None:
    from liteasr_tpu_torch import infer, parallel
    from liteasr_tpu_torch.config import compose

    cfg = compose(list(overrides))
    parallel.distributed_init(cfg.distributed, CPU)
    try:
        results = infer.infer(cfg, device=CPU)
        with open(out, "w") as f:
            json.dump({"results": results, "world": parallel.process_count()}, f)
    finally:
        parallel.destroy()


if __name__ == "__main__":
    torch.set_num_threads(2)
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "reductions":
        reductions(args[0], int(args[1]), int(args[2]), args[3])
    elif cmd == "train":
        train(args[0], args[1:])
    elif cmd == "decode":
        decode(args[0], args[1:])
    else:
        raise SystemExit(f"unknown command {cmd}")
