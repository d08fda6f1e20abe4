"""liteasr_tpu_torch's training step against liteasr_tpu's, on the CPU at
tiny sizes, weights carried from the JAX init through the bridge: train-mode
BatchNorm, CTC, the hybrid criterion, the optimizer (against FusedTx and the
optax chain), one whole train step of a 2-layer U2, and the training CLI
end to end. Also pins the framework-free copies (trigger, loader)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from liteasr_tpu.config.core import DotDict as JaxDotDict
from liteasr_tpu_torch.bridge import flax_to_state_dict
from liteasr_tpu_torch.config.core import DotDict

from test_torch_u2 import build_pair, ragged_batch, t

V = 30  # test_torch_u2.TINY vocab


def _grad_close(got, ref, name, tol=1e-3):
    np.testing.assert_allclose(got, ref, rtol=tol, atol=1e-5, err_msg=name)


# ----------------------------------------------------------- BatchNorm


def test_train_batch_norm_matches_jax():
    from liteasr_tpu.ops.batch_norm import train_batch_norm as jax_bn
    from liteasr_tpu_torch.ops.batch_norm import train_batch_norm

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(3, 11, 8)).astype(np.float32)
    gamma = rng.normal(size=8).astype(np.float32)
    beta = rng.normal(size=8).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    (jy, jmean, jvar), vjp = jax.vjp(
        lambda a, g, b: jax_bn(a, g, b, 1e-5), *map(jnp.asarray, (x, gamma, beta)))
    jgrads = vjp((jnp.asarray(dy), jnp.zeros(8), jnp.zeros(8)))
    args = [t(a).requires_grad_() for a in (x, gamma, beta)]
    y, mean, var = train_batch_norm(*args, 1e-5)
    (y * t(dy)).sum().backward()
    for got, ref in ((y, jy), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    for name, a, g in zip(("x", "gamma", "beta"), args, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_batch_norm_module_running_update():
    """FusedBatchNorm's train apply: output and the 0.99/0.01 running update
    with the biased variance, against the port's module."""
    from liteasr_tpu.nets.layers import FusedBatchNorm
    from liteasr_tpu_torch.nets.layers import BatchNorm

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    jbn = FusedBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), x, use_running_average=True)
    variables = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        size=a.shape).astype(np.float32) * 0.1, jax.device_get(variables))
    variables["batch_stats"]["var"] = np.abs(variables["batch_stats"]["var"]) + 0.5
    jy, new = jbn.apply(variables, x, use_running_average=False,
                        mutable=["batch_stats"])
    bn = BatchNorm(6)
    sd = {"weight": variables["params"]["scale"], "bias": variables["params"]["bias"],
          "running_mean": variables["batch_stats"]["mean"],
          "running_var": variables["batch_stats"]["var"]}
    bn.load_state_dict({k: t(v) for k, v in sd.items()})
    with torch.no_grad():
        y = bn(t(x), train=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- CTC


def test_ctc_matches_jax_with_an_infeasible_row():
    from liteasr_tpu.ops.ctc import ctc_loss_logits as jax_ctc
    from liteasr_tpu_torch.ops.ctc import ctc_loss_logits

    rng = np.random.default_rng(2)
    B, T, U = 4, 12, 5
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    tgt = rng.integers(1, V, size=(B, U)).astype(np.int32)
    tgt[1, 1] = tgt[1, 0]  # a repeat
    in_lens = np.array([12, 9, 3, 12], np.int32)   # row 2 is infeasible
    lab_lens = np.array([5, 4, 5, 0], np.int32)
    feasible = np.array([1, 1, 0, 1], np.float32)
    jloss, jgrad = jax.value_and_grad(lambda h: (jax_ctc(
        h, jnp.asarray(tgt), jnp.asarray(in_lens), jnp.asarray(lab_lens))
        * feasible).sum())(jnp.asarray(logits))
    j_per = np.asarray(jax_ctc(jnp.asarray(logits), jnp.asarray(tgt),
                               jnp.asarray(in_lens), jnp.asarray(lab_lens)))
    h = t(logits).requires_grad_()
    per = ctc_loss_logits(h, t(tgt), t(in_lens), t(lab_lens))
    (per * t(feasible)).sum().backward()
    live = feasible > 0
    np.testing.assert_allclose(per.detach().numpy()[live], j_per[live],
                               rtol=1e-4, atol=1e-4)
    assert per[2].item() == 0.0 and j_per[2] > 1e29  # zero_infinity vs filler
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-5)


# ----------------------------------------------------------- criterion


def _cfg(**kw):
    base = dict(vocab_size=V, padding_idx=-1, smoothing=0.1,
                normalize_length=False, ctc_weight=0.3)
    base.update(kw)
    return base


def _batch(seed):
    """A ragged batch with one infeasible CTC row and one dummy row."""
    xs, xlens, ys, ylens = ragged_batch(seed, B=3, T=57, L=12)
    xlens[2] = 19  # T' = 3 frames for 1..12 labels
    ylens[2] = 9
    ys[2, :9] = np.arange(1, 10)
    ys[2, 9:] = -1
    valid = np.array([1.0, 1.0, 1.0], np.float32)
    xs = np.concatenate([xs, np.zeros_like(xs[:1])])
    return dict(xs=xs, xlens=np.append(xlens, 7).astype(np.int32),
                ys=np.concatenate([ys, np.full((1, ys.shape[1]), -1, np.int32)]),
                ylens=np.append(ylens, 0).astype(np.int32),
                valid=np.append(valid, 0.0).astype(np.float32))


def _torch_batch(b):
    from liteasr_tpu_torch.trainer import to_device

    return to_device(b, torch.device("cpu"))


@pytest.mark.parametrize("smoothing,ctc_weight", [(0.1, 0.3), (0.0, 0.5)])
def test_criterion_matches_jax(smoothing, ctc_weight):
    from liteasr_tpu.criterions.hybrid_ctc_attn import HybridCTCLoss as JaxLoss
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss

    jmodel, variables, tmodel = build_pair(5)
    b = _batch(5)
    cfg = _cfg(smoothing=smoothing, ctc_weight=ctc_weight)
    jcrit = JaxLoss(JaxDotDict(cfg))
    jloss, jaux = jax.jit(lambda v, jb: jcrit(jmodel, v, jb, train=False))(
        variables, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        loss, aux = HybridCTCLoss(DotDict(cfg))(tmodel, _torch_batch(b), train=False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-5)
    for key in ("loss_attn", "loss_ctc", "ctc_infeasible"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert aux["ctc_infeasible"].item() == 1.0


# ----------------------------------------------------------- optimizer


def _grad_stream(n, nan_at=()):
    rng = np.random.default_rng(3)
    grads = []
    for i in range(n):
        g = {"w": (rng.normal(size=(2, 3)) * 4).astype(np.float32),
             "b": (rng.normal(size=(3,)) * 4).astype(np.float32)}
        if i in nan_at:
            g = {k: v * np.nan for k, v in g.items()}
        grads.append(g)
    return grads


def _jax_optimizer():
    from liteasr_tpu.optims import build_optimizer

    return build_optimizer(JaxDotDict(
        name="noam", lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-9,
        weight_decay=0.0, amsgrad=False, model_dim=4, factor=1.0, warmup=2))


def test_optimizer_matches_fused_tx_and_optax_chain():
    """4 micro-steps, accum 2, clip 5 (the gradients' norm is above it),
    micro-step 2 all NaN: the second window is skipped."""
    from liteasr_tpu.optims.fused_step import FusedTx
    from liteasr_tpu.trainer import build_tx as jax_build_tx
    from liteasr_tpu_torch.optims.fused_step import FusedAdam
    from liteasr_tpu_torch.optims.noam import noam_schedule

    p0 = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) / 10,
          "b": np.ones(3, np.float32)}
    grads = _grad_stream(4, nan_at=(2,))
    jopt = _jax_optimizer()
    fused = FusedTx(jopt.schedule, b1=0.9, b2=0.98, eps=1e-9, clip=5.0, accum=2)
    chain = jax_build_tx(jopt, JaxDotDict(accum_grad=2, clip_grad_norm=5.0))
    fp, cp = dict(p0), dict(p0)
    fs, cs = fused.init(fp), chain.init(cp)
    params = [t(p0["w"]).clone(), t(p0["b"]).clone()]
    tx = FusedAdam(params, noam_schedule(4, 1.0, 2), 0.9, 0.98, 1e-9,
                   clip=5.0, accum=2)
    history = []
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        fp, fs = fused.apply(jg, fs, fp)
        upd, cs = chain.update(jg, cs, cp)
        cp = optax.apply_updates(cp, upd)
        tx.update([t(g["w"]), t(g["b"])])
        history.append([p.clone() for p in params])
        for ref, tol in ((fp, 1e-6), (cp, 1e-5)):
            np.testing.assert_allclose(params[0].numpy(), np.asarray(ref["w"]),
                                       rtol=tol, atol=tol, err_msg=f"step {i}")
            np.testing.assert_allclose(params[1].numpy(), np.asarray(ref["b"]),
                                       rtol=tol, atol=tol, err_msg=f"step {i}")
    assert not torch.equal(history[1][0], torch.from_numpy(p0["w"]))
    for a, b in zip(history[1], history[3]):  # the NaN window left them as they were
        assert torch.equal(a, b)
    assert int(tx.count) == int(fs.count) == 1
    assert int(tx.notfinite_count) == int(fs.notfinite_count) == 1


def test_skipped_step_leaves_state_bit_identical():
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule

    params = [torch.randn(5, 4, generator=torch.Generator().manual_seed(0))]
    tx = FusedAdam(params, constant_schedule(0.1), 0.9, 0.999, 1e-8, clip=1.0)
    tx.update([torch.ones(5, 4)])
    before = [params[0].clone(), tx.mu.clone(), tx.nu.clone(), tx.count.clone()]
    bad = torch.ones(5, 4)
    bad[0, 0] = float("inf")
    tx.update([bad])
    for a, b in zip(before, (params[0], tx.mu, tx.nu, tx.count)):
        assert torch.equal(a, b)
    assert int(tx.notfinite_count) == 1


def test_amsgrad_matches_optax_chain():
    """optimizer=adam with amsgrad through the port's build_tx against the
    JAX trainer's chain, accumulate_every_k(apply_if_finite(chain(
    clip_by_global_norm(5), scale_by_amsgrad, scale(-lr))), 2): 12
    micro-steps whose gradients shrink (so that nu_max, not the corrected
    nu, sets the step), window 3 non-finite. Within 1e-5 at every
    micro-step; the skipped window leaves params, mu, nu and nu_max bit
    identical; plain Adam on the same stream ends elsewhere."""
    from liteasr_tpu.optims import build_optimizer as jax_build_optimizer
    from liteasr_tpu.trainer import build_tx as jax_build_tx
    from liteasr_tpu_torch.optims import build_optimizer
    from liteasr_tpu_torch.optims.fused_step import build_tx

    cfg = dict(name="adam", lr=1e-2, beta1=0.9, beta2=0.99, eps=1e-8,
               weight_decay=0.0, amsgrad=True)
    ocfg = DotDict(accum_grad=2, clip_grad_norm=5.0)
    chain = jax_build_tx(jax_build_optimizer(JaxDotDict(cfg)),
                         JaxDotDict(accum_grad=2, clip_grad_norm=5.0))
    p0 = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) / 10,
          "b": np.ones(3, np.float32)}
    cp, cs = dict(p0), chain.init(dict(p0))
    params = [t(p0["w"]).clone(), t(p0["b"]).clone()]
    plain = [p.clone() for p in params]
    tx = build_tx(build_optimizer(dict(cfg)), ocfg, params)
    tx_plain = build_tx(build_optimizer(dict(cfg, amsgrad=False)), ocfg, plain)
    assert tx.amsgrad and not tx_plain.amsgrad
    grads = _grad_stream(12, nan_at=(5,))
    for i, g in enumerate(grads):
        g = {k: v * 0.5 ** (i // 2) for k, v in g.items()}
        upd, cs = chain.update({k: jnp.asarray(v) for k, v in g.items()}, cs, cp)
        cp = optax.apply_updates(cp, upd)
        before = [x.clone() for x in (*params, tx.mu, tx.nu, tx.nu_max)]
        tx.update([t(g["w"]), t(g["b"])])
        tx_plain.update([t(g["w"]), t(g["b"])])
        if i == 5:  # the non-finite window
            for a, b in zip(before, (*params, tx.mu, tx.nu, tx.nu_max)):
                assert torch.equal(a, b)
        for p, key in zip(params, ("w", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(cp[key]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {i}")
    assert int(tx.count) == 5 and int(tx.notfinite_count) == 1
    assert torch.any(tx.nu_max > tx.nu / (1 - 0.99 ** 5))  # the max held
    assert not torch.allclose(params[0], plain[0], rtol=1e-3, atol=1e-4)


# ------------------------------------------------------ whole train step


def test_train_step_matches_jax():
    """One step of a 2-layer U2 in fp32 with dropout 0: loss, every grad,
    the new BatchNorm statistics and the updated params. The rel-pos
    attention runs through K3's plain path on the port's side."""
    from liteasr_tpu.criterions.hybrid_ctc_attn import HybridCTCLoss as JaxLoss
    from liteasr_tpu.optims.fused_step import FusedTx
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule

    jmodel, variables, tmodel = build_pair(6)
    b = _batch(6)
    cfg = _cfg()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jcrit = JaxLoss(JaxDotDict(cfg))

    def loss_fn(params):
        return jcrit(jmodel, {"params": params,
                              "batch_stats": variables["batch_stats"]},
                     jb, rngs=None, train=True)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    # Adam with a large eps: the grads that are 0 up to rounding (the conv
    # bias in front of train-mode BatchNorm) must not be normalized to +-lr
    lr, eps = 1e-2, 1e-3
    fused = FusedTx(lambda s: jnp.full((), lr, jnp.float32), b1=0.9, b2=0.999,
                    eps=eps, clip=5.0)
    jparams, _ = fused.apply(jgrads, fused.init(variables["params"]),
                             variables["params"])

    loss, _ = HybridCTCLoss(DotDict(cfg))(tmodel, _torch_batch(b), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-5)

    ref_grads = flax_to_state_dict({"params": jax.device_get(jgrads)})
    named = dict(tmodel.named_parameters())
    assert set(ref_grads) == set(named)
    for name, p in named.items():
        _grad_close(p.grad.numpy(), ref_grads[name].numpy(), name)

    new_stats = flax_to_state_dict(
        {"batch_stats": jax.device_get(jaux["model_state"]["batch_stats"])})
    buffers = dict(tmodel.named_buffers())
    assert new_stats and set(new_stats) <= set(buffers)
    for name, ref in new_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)

    params = list(named.values())
    tx = FusedAdam(params, constant_schedule(lr), 0.9, 0.999, eps, clip=5.0)
    tx.update([p.grad for p in params])
    ref_params = flax_to_state_dict({"params": jax.device_get(jparams)})
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_dropout_changes_the_train_forward_only():
    """Dropout > 0: the train forward differs between seeds, eval does
    not move, and the attention kernels' seeds come from the model's
    generator."""
    from liteasr_tpu_torch.models.u2 import U2
    from test_torch_u2 import TINY

    model = U2(**TINY, dropout_rate=0.3, enc_dropout_rate=0.3,
               enc_attn_dropout_rate=0.3, dec_dropout_rate=0.3,
               generator=torch.Generator().manual_seed(0))
    xs, xlens, ys, ylens = (t(a) for a in ragged_batch(7))
    args = (xs, xlens, ys.long(), ylens)
    with torch.no_grad():
        e1 = model(*args)[1]
        e2 = model(*args)[1]
        torch.manual_seed(0)
        model.seed_dropout(0)
        a = model(*args, train=True)[1]
        torch.manual_seed(0)
        model.seed_dropout(0)
        b = model(*args, train=True)[1]
        c = model(*args, train=True)[1]
    assert torch.equal(e1, e2) and torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, e1)


# ------------------------------------------------------------ the CLI


def _train_overrides(corpus, out):
    return [
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc",
        "optimizer=my_noam", f"task.vocab={corpus / 'vocab.txt'}",
        f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
        f"task.test=[{corpus / 'test'}]", f"task.save_dir={out / 'ckpts'}",
        f"common.run_dir={out}", f"common.results_file={out / 'results.jsonl'}",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "dataset.batch_size=4", "dataset.num_workers=1",
        "postprocess.workflow=[]", "optimization.max_epoch=1",
        "optimizer.warmup=10"]


def test_train_cli_writes_a_checkpoint_that_infer_decodes(tiny_corpus, tmp_path):
    import json

    from liteasr_tpu_torch import infer, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    trainer = train.main(_train_overrides(tiny_corpus, tmp_path),
                         device=torch.device("cpu"))
    assert trainer.epoch == 1 and int(trainer.tx.count) == 1  # 3 batches, accum 2
    assert (tmp_path / "ckpts" / "model.ep.1.pt").is_file()
    log = (tmp_path / "train.log").read_text()
    assert "valid loss:" in log
    rows = [json.loads(r) for r in (tmp_path / "results.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["run_meta", "valid"]
    assert np.isfinite(rows[1]["valid_loss"])
    trainer.inference()  # the `inference` trigger event: decodes task.test
    assert "test error rate:" in (tmp_path / "train.log").read_text()
    cfg = compose(["inference.ckpt_name=1", "inference.model_avg=false",
                   "inference.batch_size=2", "inference.beam_size=2"],
                  base=load_yaml(str(tmp_path / "config.yaml")))
    results = infer.infer(cfg, device=torch.device("cpu"))
    assert len(results) == 1 and results[0][1] > 0


@pytest.mark.parametrize("override", [
    "postprocess.on_device=true", "dataset.fbank=true", "common.resume=auto",
    "common.memory_save=true", "distributed.dp=2", "model.remat=true",
    "distributed.tp=2"])
def test_unported_options_raise(tiny_corpus, tmp_path, override):
    """distributed.tp=2 needs a process group of a multiple of 2 processes
    (tests/test_torch_tp.py runs it); distributed.dp must be -1 or the number
    of processes (one here); the other options run (tests/test_torch_resume.py and
    tests/test_torch_frontend.py hold them to the JAX package), and
    dataset.fbank on a feats.scp corpus says that it needs wav.scp."""
    import shutil

    from liteasr_tpu_torch import train

    if override == "common.memory_save=true":  # it stages into the train dir
        shutil.copytree(tiny_corpus, tmp_path / "corpus")
        tiny_corpus = tmp_path / "corpus"
    overrides = _train_overrides(tiny_corpus, tmp_path) + [override]
    if override.startswith("postprocess"):
        overrides.remove("postprocess.workflow=[]")
    device = torch.device("cpu")
    if override == "distributed.dp=2":
        with pytest.raises(ValueError, match="dp must be -1 or the number of processes"):
            train.main(overrides, device=device)
    elif override == "distributed.tp=2":
        with pytest.raises(ValueError, match="dp must be -1 or the number of processes "
                                             "over sp x tp"):
            train.main(overrides, device=device)
    elif override == "dataset.fbank=true":
        with pytest.raises(AssertionError, match="wav.scp"):
            train.main(overrides, device=device)
    else:
        trainer = train.main(overrides, device=device)
        assert trainer.epoch == 1 and trainer.step == 3
        assert (trainer.spec_aug is not None) == override.startswith("postprocess")
        assert trainer.model.encoder.remat == (override == "model.remat=true")


# ----------------------------------------------- framework-free copies


def test_trigger_and_loader_copies_match():
    from liteasr_tpu.data.loader import EpochDataLoader as JaxLoader
    from liteasr_tpu.utils.trigger import EventManager as JaxEvents
    from liteasr_tpu_torch.data.loader import EpochDataLoader
    from liteasr_tpu_torch.utils.trigger import EventManager

    logs = []
    for cls in (JaxEvents, EventManager):
        log = []
        em = cls()
        em.register(lambda: log.append("it3"), 3, "iteration")
        em.register(lambda: log.append("ep1"), 1, "epoch")
        em.align(4, 0)
        for count in (5, 6, 7, 11, 12):
            em.poll(count, "iteration")
            em.poll(count // 4, "epoch")
        logs.append(log)
    assert logs[0] == logs[1] and logs[0]

    class Data(list):
        def collator(self, items):
            return items * 2

    data = Data(range(7))
    runs = []
    for cls in (JaxLoader, EpochDataLoader):
        it = iter(cls(data, seed=3, num_workers=2))
        runs.append([next(it) for _ in range(17)])
    assert runs[0] == runs[1]
