"""Tensor parallelism on the port (``parallel.sharding``), on the CPU over
gloo, against one process and against the JAX package.

* The rules: for every leaf of the JAX my_U2 tree at tiny dims, the port
  shards the dim that ``liteasr_tpu.parallel.sharding.param_specs`` gives
  (a flax kernel (in, out) is the port's weight transposed), apart from the
  GLU pairs: ``pointwise_conv1`` is column-parallel in both but holds the
  rank's (a, b) pairs here, and the depthwise conv and the conv module's
  BatchNorm, replicated by JAX, follow those channels here. Cutting the
  bridge's full dict into shards and joining them gives it back, bit for
  bit.
* K1/K1'/K2's plain versions at a head offset (``Shard.head0`` of
  ``h_total``) give the whole call's heads (fp32, 1e-6), and
  ``dropout_keep_global`` there is the whole mask's slice, bit for bit.
* One update of a tiny conformer U2 (BatchNorm, two accumulated
  micro-steps, clip 1, dropout 0) at tp = 2 and at dp = 2 x tp = 2 (4
  ranks) against one process: the loss, every gathered gradient, the
  BatchNorm statistics and the updated parameters within rtol 1e-4, atol
  1e-6 (tests/test_torch_dp.py's gloo bound); at dropout 0.1 the
  activations the tp group holds whole are bitwise equal across it. In
  float64 the layouts give the one-process gradient, loss and BatchNorm
  statistics to 1e-12 of each leaf's max: they compute the same function,
  and what fp32 shows is the reordered sums' rounding.
* At tp = 2 and at sp = 2, dropout 0.1, a step whose encoder layers are
  rematerialized equals the plain step on every rank (the one-process
  bound of tests/test_torch_resume.py): the recompute replays the dropout
  streams keyed by coordinate.
* The train CLI at tp = 2 against the JAX package's dp = 4 x tp = 2 run
  (tests/test_tensor_parallel.py's configuration: a transformer encoder)
  on its 8 CPU devices: the mean loss and the parameters after one epoch
  within JAX's own bounds there (rtol 2e-4, atol 2e-4).
* The train CLI at tp = 2 with the valid, save_model and inference
  triggers: the checkpoint has the one-process layout and loads at tp = 1,
  the valid and error-rate lines are the one-process run's, and a resumed
  tp = 2 run ends where the uninterrupted one does.
* A layout that does not fit raises, and so does wav2vec 2.0.

Every subprocess runs under a hard 180 s limit (torch_dp_worker.launch).
"""

import json
import re
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from liteasr_tpu_torch.ops import flash_attention as fa
from liteasr_tpu_torch.parallel import sharding

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-6  # tests/test_torch_dp.py
JAX_TOL = 2e-4  # tests/test_tensor_parallel.py
# the leaves whose gradient is 0 in exact arithmetic (a bias in front of
# train-mode BatchNorm, the attention key biases)
ZERO_LEAVES = (".conv.depthwise_conv.bias", ".linear_k.bias")


@pytest.fixture(autouse=True, scope="module")
def _restore_prng_impl():
    """The JAX Trainer sets the process-global PRNG implementation and never
    restores it (liteasr_tpu/trainer.py:172-174); put it back."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


# ----------------------------------------------------------------- rules

def _tiny_state_dict():
    from liteasr_tpu_torch.models.u2 import U2

    return U2(**w.U2_TINY, generator=torch.Generator().manual_seed(0)).state_dict()


def _jax_dim(spec, leaf: str, ndim: int):
    """The port's shard dim that a JAX PartitionSpec of a flax leaf means."""
    dims = [i for i, a in enumerate(tuple(spec)) if a == "tp"]
    if not dims:
        return None
    return 1 - dims[0] if leaf == "kernel" and ndim == 2 else dims[0]


def test_rules_follow_jax_param_specs():
    from liteasr_tpu.parallel.sharding import param_specs
    from liteasr_tpu_torch.bridge import _flatten, _leaf_to_torch, state_dict_to_flax

    variables = state_dict_to_flax(_tiny_state_dict())
    specs = param_specs(variables["params"])
    spec_of = dict(_flatten(specs))
    checked, glu, channels = 0, 0, 0
    for path, arr in _flatten(variables["params"]):
        key, _ = _leaf_to_torch(path, arr)
        want = _jax_dim(spec_of[path], path[-1], arr.ndim)
        got = sharding.shard_dim(key, arr.ndim)
        if re.search(r"conv\.(depthwise_conv|norm)\.", key):
            assert want is None and got == 0, key  # the GLU pairs' channels
            channels += 1
            continue
        assert got == want, (key, spec_of[path], got)
        glu += sharding.is_glu(key)
        checked += 1
    for path, arr in _flatten(variables["batch_stats"]):  # replicated in JAX
        assert sharding.shard_dim(".".join(path[:-1]) + ".running_mean", 1) == 0
    assert checked > 50 and glu == 2 * w.U2_TINY["enc_layers"] and channels == 4 * w.U2_TINY["enc_layers"]


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_join_to_the_bridge_dict(tp):
    from liteasr_tpu_torch.bridge import flax_to_shard, flax_to_state_dict, state_dict_to_flax

    full = flax_to_state_dict(state_dict_to_flax(_tiny_state_dict()))
    shards = [sharding.shard_state_dict(full, r, tp) for r in range(tp)]
    assert shards[0]["encoder.layer_0.feed_forward.fc1.weight"].shape[0] == 64 // tp
    glu = shards[1]["encoder.layer_0.conv.pointwise_conv1.weight"]
    d = full["encoder.layer_0.conv.pointwise_conv1.weight"].shape[0] // 2
    assert torch.equal(glu[d // tp:], full["encoder.layer_0.conv.pointwise_conv1.weight"]
                       [d + d // tp:d + 2 * d // tp])  # rank 1's b half
    merged = sharding.merge_state_dicts(shards)
    assert merged.keys() == full.keys()
    for key, val in full.items():
        assert torch.equal(merged[key], val), key
    variables = state_dict_to_flax(full)  # a JAX tree straight to a rank's shard
    for r in range(tp):
        got = flax_to_shard(variables, r, tp)
        assert all(torch.equal(got[k], v) for k, v in shards[r].items())


# ----------------------------------------------------- kernels at head0

def _attn_inputs(b, h, t, d, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.5).astype(np.float32))

    kv = torch.from_numpy(np.resize(np.array([t, t - 5, 0, t - 11], np.int32), b * h))
    return dict(q_u=mk(b * h, t, d), qv=mk(b * h, t, d), k=mk(b * h, t, d),
                v=mk(b * h, t, d), p=mk(h, t, d), kv_lens=kv, dout=mk(b * h, t, d))


@pytest.mark.parametrize("head0", [0, 2])
@pytest.mark.parametrize("chunk", [0, 4])
def test_plain_kernels_at_a_head_offset(head0, chunk):
    B, H, T, D, rate, seed = 3, 4, 21, 8, 0.2, 77
    x = _attn_inputs(B, H, T, D)
    rows = torch.tensor([b * H + h for b in range(B) for h in range(head0, head0 + 2)])
    shard = fa.Shard(head0=head0, h_local=2, h_total=H)

    def run(x, shard):
        out, lse = fa.flash_attention_plain(
            x["q_u"], x["k"], x["v"], kv_lens=x["kv_lens"], rel_qv=x["qv"], rel_p=x["p"],
            scale=0.35, return_lse=True, dropout_rate=rate, dropout_seed=seed, chunk=chunk,
            shard=shard)
        grads = fa.flash_rel_attention_bwd_plain(
            x["q_u"], x["qv"], x["k"], x["v"], x["p"], x["kv_lens"], out.float(), lse,
            x["dout"], 0.35, rate, seed, chunk, shard)
        return out, lse, grads

    full = run(x, fa.WHOLE)
    part = {n: x[n][rows] for n in ("q_u", "qv", "k", "v", "kv_lens", "dout")}
    part["p"] = x["p"][head0:head0 + 2]
    got = run(part, shard)
    torch.testing.assert_close(got[0], full[0][rows], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], full[1][rows], rtol=0, atol=1e-6)
    for name, g, r in zip(("dq_u", "dqv", "dk", "dv"), got[2], full[2]):
        torch.testing.assert_close(g, r[rows], rtol=0, atol=1e-6, msg=name)
    torch.testing.assert_close(got[2][4], full[2][4][head0:head0 + 2], rtol=0, atol=1e-6)
    keep = fa.dropout_keep_global(B * 2, T, T, seed, rate, shard=shard)
    assert torch.equal(keep, fa.dropout_keep_global(B * H, T, T, seed, rate)[rows])


# --------------------------------------------------- steps against one

@pytest.fixture(scope="module")
def one_process():
    return w.tpsp_step()


@pytest.fixture(scope="module")
def one_process64():
    return {v: w.tpsp_grad64(v) for v in w.TPSP_VARIANTS}


def _ranks(tmp_path, world, sp, tp, *extra):
    addr = w.free_address()
    runs = w.launch([[sys.executable, w.WORKER, "tpsp", addr, str(world), str(r), str(sp),
                      str(tp), str(tmp_path / f"r{r}.pt"), *extra] for r in range(world)],
                    timeout=180)
    for r, (code, text) in enumerate(runs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
    return [torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(world)]


def check_step(ranks, ref, grad_atol_of_top=False):
    """The global loss (the dp x sp ranks' shares, one tp rank each), the
    gathered gradient, the parameters and statistics after the update,
    against one process; the same on every rank. The zero-gradient leaves'
    atol is of the largest gradient, and with ``grad_atol_of_top`` every
    leaf's is (a loss of ~30 nats a row, as the transducer's, makes the
    gradient ~10x U2's and its reordered fp32 sums reach 2.5e-6 on a leaf
    whose max is 1.2)."""
    shares = [r["losses"] for r in ranks if r["layout"].tp_i == 0]
    torch.testing.assert_close(sum(shares), ref["losses"], rtol=RTOL, atol=ATOL)
    top = max(g.abs().max().item() for g in ref["grads"].values())
    grad_norm = sum(g.square().sum() for g in ref["grads"].values()).sqrt().item()
    assert grad_norm > 1.0  # the clip at 1 scales the step
    for r in ranks:
        assert (r["count"], r["notfinite"]) == (1, 0)
        for key, g in ref["grads"].items():
            scaled = grad_atol_of_top or key.endswith(ZERO_LEAVES)
            np.testing.assert_allclose(r["grads"][key].numpy(), g.numpy(), rtol=RTOL,
                                       atol=ATOL * (top if scaled else 1), err_msg=key)
        assert r["state"].keys() == ref["state"].keys()
        for key, val in ref["state"].items():  # parameters and running statistics
            np.testing.assert_allclose(r["state"][key].numpy(), val.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def check_fp64(ranks, ref, tol=1e-12):
    """In float64: the global loss, every gradient leaf and the BatchNorm
    statistics within ``tol`` of the leaf's max (the zero-gradient leaves:
    of the largest gradient)."""
    shares = sum(r["losses"] for r in ranks if r["layout"].tp_i == 0)
    assert abs(shares.item() - ref["losses"].item()) <= tol * abs(ref["losses"].item())
    top = max(g.abs().max().item() for g in ref["grads"].values())
    for r in ranks:
        for key, g in ref["grads"].items():
            scale = top if key.endswith(ZERO_LEAVES) else g.abs().max().item()
            assert (r["grads"][key] - g).abs().max().item() <= tol * scale, key
        for key, val in ref["state"].items():
            assert (r["state"][key] - val).abs().max().item() <= tol * max(
                val.abs().max().item(), 1.0), key


@pytest.mark.parametrize("world,sp,tp,variant", [
    (2, 1, 2, "conformer"), (4, 1, 2, "conformer"), (2, 2, 1, "conformer"),
    (4, 2, 2, "conformer"), (2, 1, 2, "chunk_rel"), (2, 2, 1, "chunk_rel"),
    (2, 1, 2, "chunk_abs"), (2, 2, 1, "chunk_abs")],
    ids=["tp2", "dp2_tp2", "sp2", "sp2_tp2", "tp2_chunk_rel", "sp2_chunk_rel",
         "tp2_chunk_abs", "sp2_chunk_abs"])
def test_layouts_equal_one_process_in_fp64(tmp_path, one_process64, world, sp, tp, variant):
    """Both encoder architectures, the streaming one with a static chunk
    width, with and without rel-pos attention."""
    check_fp64(_ranks(tmp_path, world, sp, tp, "fp64", variant), one_process64[variant])


@pytest.mark.parametrize("world,dp", [(2, 1), (4, 2)], ids=["tp2", "dp2_tp2"])
def test_tp_step_equals_one_process(tmp_path, one_process, world, dp):
    ranks = _ranks(tmp_path, world, 1, 2)
    assert [r["layout"].dp for r in ranks] == [dp] * world
    check_step(ranks, one_process)
    counts = ranks[0]["counts"]
    assert counts["activation@tp"] > 0 and counts["activation_grad@tp"] > 0
    assert counts["grad"] == 1 and counts["grad_norm@tp"] == 1
    for a, b in zip(ranks[0::2], ranks[1::2]):  # tp peers at dropout 0.1
        for key in ("dropout_h_enc", "dropout_h_attn", "dropout_h_ctc"):
            assert torch.equal(a[key], b[key]), key
    if dp == 2:  # the dp peers hold other rows
        assert not torch.equal(ranks[0]["dropout_h_ctc"], ranks[2]["dropout_h_ctc"])


@pytest.mark.parametrize("sp,tp", [(1, 2), (2, 1)], ids=["tp2", "sp2"])
def test_remat_step_equals_the_plain_step_with_dropout(tmp_path, sp, tp):
    """The conformer (the FFNs' dropout) and the streaming transformer
    without rel-pos (the attention's dropout too) draw from the "tp"
    stream under tp; the recompute of a rematerialized layer must draw
    the masks the forward drew."""
    for rank in _ranks(tmp_path, 2, sp, tp, "remat"):
        for variant in ("conformer", "chunk_abs"):
            plain, remat = rank[variant, False], rank[variant, True]
            assert torch.equal(remat["loss"], plain["loss"]), variant
            for name, g in plain["grads"].items():
                torch.testing.assert_close(remat["grads"][name], g, rtol=1e-6, atol=1e-7,
                                           msg=f"{variant} {name}")
            for key, state in plain["streams"].items():  # the recompute drew none
                assert torch.equal(remat["streams"][key], state), (variant, key)
        if tp == 2:  # the FFNs' dropout drew from the "tp" stream
            assert ("tp", "cpu") in rank["conformer", False]["streams"]


# ------------------------------------------------------ the train CLI

def _jax_overrides(corpus, out, **dist):
    """tests/test_tensor_parallel.py's configuration."""
    return [
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_noam",
        f"task.vocab={corpus / 'vocab.txt'}", f"task.train={corpus / 'train'}",
        f"task.valid={corpus / 'valid'}", f"task.save_dir={out / 'ckpts'}",
        f"common.run_dir={out}", "model.enc_arch=transformer", "model.enc_layers=1",
        "model.dec_layers=1", "model.enc_dim=32", "model.enc_ff_dim=64",
        "model.dec_dim=32", "model.dec_ff_dim=64", "model.enc_attn_heads=2",
        "model.dec_attn_heads=2", "model.dropout_rate=0.0", "dataset.batch_size=8",
        "dataset.pad_time_multiple=64", "dataset.pad_label_multiple=8",
        "optimization.max_epoch=1", "optimization.accum_grad=1",
        "optimization.clip_grad_norm=5.0", "optimizer.factor=0.1",
        "optimizer.model_dim=32", "postprocess.workflow=[]", "dataset.num_workers=1",
        *[f"distributed.{k}={v}" for k, v in dist.items()]]


def jax_against_port(corpus, root, sp, tp):
    """The JAX package's dp x sp x tp run on its 8 CPU devices and the
    port's sp x tp run of 2 processes from the JAX run's init, started as
    soon as that init exists. Returns (JAX trainer, port checkpoint, each
    rank's losses)."""
    import liteasr_tpu.trainer as jtrainer
    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu.parallel import mesh as jmesh
    from liteasr_tpu.train import train as jax_train
    from liteasr_tpu_torch.bridge import flax_to_state_dict

    init, started = root / "init.pt", {}
    run = jtrainer.Trainer.run

    def capture(self):
        st = jax.device_get(self.state)
        torch.save(flax_to_state_dict({"params": st.params}), init)
        addr = w.free_address()
        started["ranks"] = w.start([[
            sys.executable, w.WORKER, "train", str(init),
            *_jax_overrides(corpus, root / "port", sp=sp, tp=tp),
            "common.trigger=[{name: save_model, interval: 1, unit: epoch}]",
            f"distributed.coordinator_address={addr}", "distributed.num_processes=2",
            f"distributed.process_id={r}"] for r in (0, 1)])
        return run(self)

    cfg = jax_compose(_jax_overrides(corpus, root / "jax", dp=8 // (sp * tp), sp=sp, tp=tp)
                      + ["common.trigger=[]"])
    jmesh._MESH = None
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtrainer.Trainer, "run", capture)
            trainer = jax_train(cfg)
        outs = [w.wait(p, 180) for p in started["ranks"]]
    finally:
        jmesh._MESH = None
        for p in started.get("ranks", []):
            p.kill()
    losses = []
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
        losses.append(json.loads(re.search(r"DP_WORKER_LOSSES (.*)", text).group(1)))
    ckpt = torch.load(root / "port" / "ckpts" / "model.ep.1.pt", weights_only=True)
    return trainer, ckpt, losses


def check_against_jax(trainer, ckpt, loss):
    from liteasr_tpu_torch.bridge import flax_to_state_dict

    jloss = np.asarray(jax.device_get(trainer._loss_accum)).mean()
    np.testing.assert_allclose(loss, jloss, rtol=JAX_TOL, atol=JAX_TOL)
    ref = flax_to_state_dict({"params": jax.device_get(trainer.state.params)})
    for key, val in ref.items():
        np.testing.assert_allclose(ckpt[key].numpy(), val.numpy(), rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=key)


def test_tp_train_cli_matches_the_jax_tp_run(tiny_corpus, tmp_path):
    trainer, ckpt, losses = jax_against_port(tiny_corpus, tmp_path, sp=1, tp=2)
    assert losses[0] == losses[1]  # tp peers hold the whole loss
    check_against_jax(trainer, ckpt, np.mean(losses[0]))


def _cli_overrides(corpus, out, epochs):
    return [
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_adam",
        "optimizer.eps=1e-3", f"task.vocab={corpus / 'vocab.txt'}",
        f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
        f"task.test=[{corpus / 'test'}]", f"task.save_dir={out / 'ckpts'}",
        f"common.run_dir={out}",
        "common.trigger=[{name: valid, interval: 1, unit: epoch}, "
        "{name: save_model, interval: 1, unit: epoch}, "
        "{name: inference, interval: 1, unit: epoch}]",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "model.enc_attn_heads=2", "model.dec_attn_heads=2", "model.dropout_rate=0.0",
        "dataset.batch_size=4", "dataset.num_workers=1", "postprocess.workflow=[]",
        f"optimization.max_epoch={epochs}", "optimization.accum_grad=2",
        "optimization.clip_grad_norm=5.0", "inference.mode=ctc_greedy",
        "inference.batch_size=3"]


def _tp2(corpus, out, epochs, addr, extra=()):
    return [[sys.executable, "-m", "liteasr_tpu_torch.train", "--device", "cpu",
             *_cli_overrides(corpus, out, epochs), *extra, "distributed.tp=2",
             f"distributed.coordinator_address={addr}", "distributed.num_processes=2",
             f"distributed.process_id={r}"] for r in (0, 1)]


def _lines(path, what):
    return [re.search(rf"\d+ / \S+ iters, .*{what}.*", ln).group(0).strip()
            for ln in path.read_text().splitlines() if what in ln]


def test_tp_train_cli_triggers_and_resume(tiny_corpus, tmp_path):
    """2 epochs at tp = 2, and 1 epoch + a resume to 2 at tp = 2, against
    one process."""
    from liteasr_tpu_torch import train

    procs = w.start(_tp2(tiny_corpus, tmp_path / "tp", 2, w.free_address())
                    + _tp2(tiny_corpus, tmp_path / "cut", 1, w.free_address()))
    try:
        trainer = train.main(_cli_overrides(tiny_corpus, tmp_path / "one", 2), device=CPU)
        outs = [w.wait(p, 180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"process {r} failed:\n{text[-4000:]}"
    outs = w.launch(_tp2(tiny_corpus, tmp_path / "cut", 2, w.free_address(),
                         ["common.resume=auto"]), timeout=180)
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"resumed rank {r} failed:\n{text[-4000:]}"

    one = tmp_path / "one"
    for what in ("valid loss:", "test error rate:"):
        ref = _lines(one / "train.log", what)
        assert len(ref) == 2, ref
        assert _lines(tmp_path / "tp" / "train.log", what) == ref, what
    for epoch in (1, 2):
        sp_ = torch.load(one / "ckpts" / f"model.ep.{epoch}.pt", weights_only=True)
        tp_ = torch.load(tmp_path / "tp" / "ckpts" / f"model.ep.{epoch}.pt", weights_only=True)
        assert {k: v.shape for k, v in tp_.items()} == {k: v.shape for k, v in sp_.items()}
        for key, val in sp_.items():
            np.testing.assert_allclose(tp_[key].numpy(), val.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"epoch {epoch} {key}")
    cut = torch.load(tmp_path / "cut" / "ckpts" / "model.ep.2.pt", weights_only=True)
    for key, val in tp_.items():  # resumed == uninterrupted, both at tp = 2
        np.testing.assert_allclose(cut[key].numpy(), val.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    trainer.model.load_state_dict(tp_, strict=True)  # into the port at tp = 1
    state = torch.load(tmp_path / "tp" / "ckpts" / "train_state.pt", weights_only=True)
    ref = torch.load(one / "ckpts" / "train_state.pt", weights_only=True)
    assert state["optimizer"]["mu"].shape == ref["optimizer"]["mu"].shape


# ------------------------------------------------------------ refusals

def test_layouts_that_do_not_fit_raise():
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.parallel import mesh

    assert mesh.check_layout(DotDict(tp=2, sp=2), 8) == mesh.Layout(2, 2, 2)
    assert mesh.check_layout(DotDict(dp=-1), 3) == mesh.Layout(3, 1, 1)
    assert mesh.Layout.of_rank(5, 2, 2, 2) == mesh.Layout(2, 2, 2, 1, 0, 1)
    for cfg, world in ((DotDict(tp=2), 1), (DotDict(tp=2, sp=2), 6),
                       (DotDict(dp=2, tp=2), 2), (DotDict(dp=4), 2)):
        with pytest.raises(ValueError, match="dp x sp x tp|dp must be -1"):
            mesh.check_layout(cfg, world)
    lay = mesh.Layout(1, 1, 2, 0, 0, 0)
    for key in ("enc_attn_heads", "dec_attn_heads", "enc_ff_dim", "dec_ff_dim", "enc_dim"):
        cfg = DotDict(w.U2_TINY, **{key: 3 if "heads" in key else 33})
        with pytest.raises(ValueError, match=f"does not divide model.{key}"):
            sharding.shard_model(w.build_case("hybrid_ctc")[0], lay, cfg)


@pytest.mark.parametrize("case", ["wav2vec"])
@pytest.mark.parametrize("tp,sp", [(2, 1), (1, 2)])
def test_other_families_raise(case, tp, sp):
    """The other families shard too (the transducer and the Paraformer:
    tests/test_torch_tp_families.py, wav2vec 2.0: tests/test_torch_tp_w2v.py);
    what raises for them is a tp that does not divide their heads."""
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.parallel import mesh

    model = sharding.shard_model(w.build_case(case)[0], mesh.Layout(1, sp, tp),
                                 DotDict(w.W2V_TINY))
    assert model.seq_parallel == (sp > 1) and getattr(model, "tp_sharded", False) == (tp > 1)
    assert type(model).__name__ in sharding.TP_WIDTHS
    with pytest.raises(ValueError, match="does not divide model.encoder_attention_heads"):
        sharding.shard_model(w.build_case(case)[0], mesh.Layout(1, sp, 2),
                             DotDict(w.W2V_TINY, encoder_attention_heads=3))
