"""Subprocess worker of the port's data-parallel tests (imports no JAX).

    python tests/torch_dp_worker.py reductions ADDR WORLD RANK OUT
    python tests/torch_dp_worker.py train INIT_STATE_DICT OVERRIDES...
    python tests/torch_dp_worker.py decode OUT OVERRIDES...
    python tests/torch_dp_worker.py tpsp ADDR WORLD RANK SP TP OUT [step|fp64|remat [VARIANT]]
    python tests/torch_dp_worker.py tpsp ADDR WORLD RANK SP TP OUT family FAMILY

``reductions``: joins a gloo group and runs every case of :data:`CASES` on
its row block of the case's global batch (:func:`run_case`), saving the
results to OUT. ``train``: ``liteasr_tpu_torch.train.main`` on the CPU, the
model starting from INIT_STATE_DICT (``-`` for the seeded init). ``decode``:
joins the group that the overrides' ``distributed.*`` name and runs
``infer.infer`` on the CPU, writing the results as JSON to OUT. ``tpsp``:
joins a gloo group of WORLD ranks laid out as (dp, SP, TP) and runs
:func:`tpsp_step` (a tiny conformer U2's two accumulated micro-steps on the
rank's rows, then the same forward at dropout 0.1), with ``fp64``
:func:`tpsp_grad64`, saving the results in the one-process layout to OUT,
or with ``remat`` :func:`tpsp_remat` (a rematerialized and a plain step at
dropout 0.1), saving the rank's own results; ``family`` runs
:func:`tpsp_family` for the transducer (``rnnt``), the Paraformer
(``paraformer``) or wav2vec 2.0 (``wav2vec``, ``wav2vec:FAULT`` with one of
``chip_smoke.W2V_TP_SP_FAULTS``' faults planted): the fp32 update, the
fp64 gradient and the eval forwards.
The test process imports this module too, for the one-process references.
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

        def hand(model, lo, hi, eval_own=False):
            """Rows lo:hi of the global draws; with ``eval_own`` in train
            mode only (eval keeps the model's own fixed streams)."""
            own_mask, own_u = model.draw_mask, model.draw_negatives_uniform
            model.draw_mask = lambda b, f, fl, train: (
                mask[lo:hi] if train or not eval_own else own_mask(b, f, fl, train))
            model.draw_negatives_uniform = lambda b, f, train, d: (
                u[lo:hi] if train or not eval_own else own_u(b, f, train, d))
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


def _tiny_u2(rate: float, **kw):
    """:data:`U2_TINY` at dropout ``rate`` everywhere, sharded as the run's
    layout says, with every random stream seeded as the train CLI seeds it
    from seed 0."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.models.u2 import U2
    from liteasr_tpu_torch.parallel import sharding

    lay = parallel.layout()
    torch.manual_seed(0)
    model = U2(**U2_TINY, **kw, dropout_rate=rate, enc_dropout_rate=rate,
               enc_pos_dropout_rate=rate, enc_attn_dropout_rate=rate,
               enc_ff_dropout_rate=rate, dec_dropout_rate=rate,
               dec_ff_dropout_rate=rate, dec_self_attn_dropout_rate=rate,
               dec_src_attn_dropout_rate=rate,
               generator=torch.Generator().manual_seed(0))
    model.seed_dropout(0)
    parallel.seed_streams(0)
    torch.manual_seed(parallel.rank_seed(0, lay.dp_i * lay.sp + lay.sp_i))
    return sharding.shard_model(model, lay, DotDict(U2_TINY))


def _rows() -> slice:
    """The dp rank's rows of a global batch of B."""
    from liteasr_tpu_torch import parallel

    lay = parallel.layout()
    return slice(lay.dp_i * B // lay.dp, (lay.dp_i + 1) * B // lay.dp)


def _full_grads(flat, named, state) -> dict:
    """A flat vector over the local parameters ``named`` as the leaves of
    the one-process layout (``state``: its state dict)."""
    from liteasr_tpu_torch.parallel import sharding

    shapes = [state[k].shape for k, _ in named]
    full = sharding.gather_flat(flat, named).split([s.numel() for s in shapes])
    return {k: g.view(s) for (k, _), g, s in zip(named, full, shapes)}


def _one_update(model, crit, parts) -> dict:
    """One update of ``len(parts)`` accumulated micro-steps (Adam, clip 1)
    of the sharded ``model`` on the device batches ``parts``. Returns, in
    the one-process layout: each micro-step's loss (the rank's share), the
    mean gradient the update took, the parameters and BatchNorm statistics
    after it, and the optimizer's counts."""
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule
    from liteasr_tpu_torch.parallel import sharding

    named = list(model.named_parameters())
    tx = FusedAdam([p for _, p in named], constant_schedule(1e-3), 0.9, 0.999, 1e-3,
                   clip=1.0, accum=len(parts), sharded=sharding.sharded_parameters(model))
    flat, step = [], tx._step

    def take(g):  # the mean gradient the update takes
        flat.append(g.clone())
        step(g)

    tx._step = take
    losses = []
    for part in parts:
        loss, _ = crit(model, dict(part, step=0), train=True)
        loss.backward()
        tx.update([p.grad for _, p in named])
        for _, p in named:
            p.grad = None
        losses.append(loss.detach())
    state = sharding.gather_state_dict(model)
    return dict(losses=torch.stack(losses), state=state, grads=_full_grads(flat[0], named, state),
                count=int(tx.count), notfinite=int(tx.notfinite_count))


def _fp64(model):
    """``model`` computing in float64."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


def _grad64(build, crit, part, eval_part=None) -> dict:
    """The gradient of one micro-step of the sharded fp64 model that
    ``build()`` makes (summed over the dp x sp ranks), the loss share and the
    BatchNorm statistics, in the one-process layout, with
    ``Tensor.float()`` keeping fp64 tensors fp64 in this process, so that
    the port's fp32 casts (the plain attention, LayerNorm, BatchNorm, the
    losses) do not round. A layout that computes the one-process step's
    function gives it to fp64's rounding. Also the step's aux (the rank's
    shares) and, with ``eval_part``, the eval loss and aux on it."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.parallel import sharding

    to_fp32 = torch.Tensor.float
    torch.Tensor.float = lambda x, *a, **k: x if x.dtype == torch.float64 else to_fp32(x, *a, **k)
    try:
        model = build()

        def wide(p):
            return dict(p, xs=p["xs"].double(), valid=p["valid"].double())

        loss, aux = crit(model, dict(wide(part), step=0), train=True)
        loss.backward()
        named = list(model.named_parameters())
        g = parallel.global_sum_(torch.cat([p.grad.reshape(-1) for _, p in named]), "grad")
        state = sharding.gather_state_dict(model)
        out = dict(losses=loss.detach()[None], aux={k: v.detach() for k, v in aux.items()},
                   state=state, grads=_full_grads(g, named, state))
        if eval_part is not None:
            with torch.no_grad():
                eloss, eaux = crit(model, wide(eval_part), train=False)
            out["eval"] = dict(loss=eloss, aux=dict(eaux))
        return out
    finally:
        torch.Tensor.float = to_fp32


def _u2_crit():
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss

    return HybridCTCLoss(DotDict(vocab_size=30, padding_idx=-1, smoothing=0.1, ctc_weight=0.3))


def tpsp_step() -> dict:
    """A tiny conformer U2 (4 heads, BatchNorm, T' = 13) trained for one
    update of two accumulated micro-steps (Adam, clip 1, dropout 0) on the
    dp rank's rows of two global batches, sharded as the run's layout
    says (:func:`_one_update`); then, at dropout 0.1 with the kernels'
    dropout too, the encoder output and the attention logits of one train
    forward (the activations a tp group holds whole)."""
    from liteasr_tpu_torch.trainer import to_device

    parts = [to_device({k: v[_rows()] for k, v in asr_batch(seed, 30).items()}, CPU)
             for seed in (1, 2)]
    out = _one_update(_tiny_u2(0.0), _u2_crit(), parts)

    model = _tiny_u2(0.1)
    seen = {}
    model.encoder.register_forward_hook(lambda m, a, o: seen.setdefault("h_enc", o.detach()))
    part = parts[0]
    h_attn, h_ctc = model(part["xs"], part["xlens"], part["ys"], part["ylens"], train=True)
    out.update(dropout_h_enc=seen["h_enc"], dropout_h_attn=h_attn.detach(),
               dropout_h_ctc=h_ctc.detach())
    return out


# tpsp_grad64's encoders besides the conformer: the streaming ones, a
# static chunk width of 3 subsampled frames, with and without rel-pos
TPSP_VARIANTS = {
    "conformer": {},
    "chunk_rel": dict(enc_arch="transformer", static_chunk_size=3),
    "chunk_abs": dict(enc_arch="transformer", use_rel=False, static_chunk_size=3),
}


def tpsp_grad64(variant: str = "conformer") -> dict:
    """The gradient of :func:`tpsp_step`'s first micro-step in float64
    (:func:`_grad64`) for the encoder of :data:`TPSP_VARIANTS`
    ``variant``."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.models.u2 import U2
    from liteasr_tpu_torch.parallel import sharding
    from liteasr_tpu_torch.trainer import to_device

    def build():
        model = _fp64(U2(**U2_TINY, **TPSP_VARIANTS[variant],
                         generator=torch.Generator().manual_seed(0)))
        return sharding.shard_model(model, parallel.layout(), DotDict(U2_TINY))

    part = to_device({k: v[_rows()] for k, v in asr_batch(1, 30).items()}, CPU)
    return _grad64(build, _u2_crit(), part)


def tpsp_remat() -> dict:
    """One train step at dropout 0.1 of :data:`TPSP_VARIANTS`' conformer and
    its streaming transformer without rel-pos (whose attention dropout, like
    the FFNs', draws from the "tp" stream under tp), each with its encoder
    layers rematerialized and without: per variant and mode, the rank's
    loss share, its local gradients and the coordinate-keyed streams'
    states after the step."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss
    from liteasr_tpu_torch.trainer import to_device

    lay = parallel.layout()
    rows = slice(lay.dp_i * B // lay.dp, (lay.dp_i + 1) * B // lay.dp)
    crit = HybridCTCLoss(DotDict(vocab_size=30, padding_idx=-1, smoothing=0.1,
                                 ctc_weight=0.3))
    part = to_device({k: v[rows] for k, v in asr_batch(1, 30).items()}, CPU)
    out = {}
    for variant in ("conformer", "chunk_abs"):
        for remat in (False, True):
            model = _tiny_u2(0.1, **TPSP_VARIANTS[variant], remat=remat)
            assert model.encoder.remat == remat
            loss, _ = crit(model, dict(part, step=0), train=True)
            loss.backward()
            out[variant, remat] = dict(
                loss=loss.detach(), streams=parallel.stream_states(),
                grads={k: p.grad.clone() for k, p in model.named_parameters()})
    return out


# the families besides U2 that tpsp's ``family`` mode runs (and wav2vec
# 2.0, which tests/test_torch_tp_w2v.py runs on its own)
TPSP_FAMILIES = ("rnnt", "paraformer")
GLANCE_SEED = 9  # the Paraformer's handed train-mode glance noise
def _tiny_family(family: str, fp64: bool = False):
    """(model, criterion, global numpy batch) of ``family`` at
    :data:`TD_TINY`, :data:`PARA_TINY` or :data:`W2V_TINY` (dropout 0),
    every stream seeded as the train CLI seeds it from seed 0, sharded as
    the run's layout says; ``fp64`` computes in float64. The Paraformer's
    train-mode glance noise and wav2vec 2.0's train-mode span mask,
    negatives' uniforms and Gumbel noise are the dp rank's rows of one
    global draw, handed over as the dp reduction tests hand them; their
    eval-mode draws are the model's own."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.parallel import sharding

    lay = parallel.layout()
    model, crit, batch, hand = build_case(family)
    if fp64:
        _fp64(model)
    model.seed_dropout(0, lay.dp_i)
    if family == "wav2vec":
        hand(model, _rows().start, _rows().stop, eval_own=True)
    parallel.seed_streams(0)
    torch.manual_seed(parallel.rank_seed(0, lay.dp_i * lay.sp + lay.sp_i))
    if family == "paraformer":
        noise = torch.rand(batch["ys"].shape, generator=torch.Generator().manual_seed(
            GLANCE_SEED))[_rows()].to(torch.float64 if fp64 else torch.float32)
        own = model.draw_glance_noise

        def draw(b, u, train, device):
            return noise[:b, :u].to(device) if train else own(b, u, train, device)

        model.draw_glance_noise = draw
    widths = {"rnnt": TD_TINY, "paraformer": PARA_TINY, "wav2vec": W2V_TINY}[family]
    return sharding.shard_model(model, lay, DotDict(widths)), crit, batch


def tpsp_family(family: str) -> dict:
    """For ``family`` (:data:`TPSP_FAMILIES`) on the dp rank's rows of its
    dp reduction case's global batch, in the one-process layout:

    * ``eval``: the eval-mode loss share and aux before the update, and the
      Paraformer's eval glance noise;
    * ``step``: one update of two accumulated micro-steps on the batch and
      its reverse (:func:`_one_update`);
    * ``fp64``: the first micro-step's gradient in float64
      (:func:`_grad64`), with the eval forward on the batch.

    ``family`` may name a wav2vec 2.0 fault, ``wav2vec:FAULT``
    (``chip_smoke.W2V_TP_SP_FAULTS``, which z12 plants on the card), planted
    for all three."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.trainer import to_device

    family, _, fault = family.partition(":")
    if fault:
        from chip_smoke import planted_w2v_fault

        with planted_w2v_fault(fault):
            return tpsp_family(family)
    lay = parallel.layout()
    model, crit, batch = _tiny_family(family)
    parts = [to_device({k: v[_rows()] for k, v in batch.items()}, CPU),
             to_device({k: v[::-1][_rows()].copy() for k, v in batch.items()}, CPU)]
    with torch.no_grad():
        eloss, eaux = crit(model, parts[0], train=False)
    out = {"eval": dict(loss=eloss, aux=dict(eaux))}
    if family == "paraformer":
        out["eval"]["noise"] = model.draw_glance_noise(B // lay.dp, 6, False, CPU)
    out["step"] = _one_update(model, crit, parts)
    out["fp64"] = _grad64(lambda: _tiny_family(family, fp64=True)[0], crit, parts[0],
                          eval_part=parts[0])
    return out


def tpsp(addr: str, world: int, rank: int, sp: int, tp: int, out: str,
         mode: str = "step", variant: str = "conformer") -> None:
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict

    parallel.distributed_init(DotDict(coordinator_address=addr, num_processes=world,
                                      process_id=rank, sp=sp, tp=tp), CPU)
    try:
        res = {"step": tpsp_step, "fp64": lambda: tpsp_grad64(variant),
               "remat": tpsp_remat, "family": lambda: tpsp_family(variant)}[mode]()
        res["counts"] = dict(parallel.counts)
        res["layout"] = parallel.layout()
        torch.save(res, out)
    finally:
        parallel.destroy()


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
    losses = [float(x) for x in trainer._loss_accum]
    print(f"DP_WORKER_LOSSES {json.dumps(losses)}", flush=True)
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
    elif cmd == "tpsp":
        tpsp(args[0], int(args[1]), int(args[2]), int(args[3]), int(args[4]), args[5],
             *args[6:8])
    else:
        raise SystemExit(f"unknown command {cmd}")
