"""Tensor and sequence parallelism for the transducer and the Paraformer on
the port (``parallel.sharding.shard_model``), on the CPU over gloo, against
one process and against the JAX package.

* The rules: for every leaf of each family's flax tree at tiny dims, the
  port shards the dim that ``liteasr_tpu.parallel.sharding.param_specs``
  gives (the conformer conv module's GLU pairs aside, as for U2); the LSTM
  prediction network, the joint, the CIF predictor and the embeddings
  match no rule and stay replicated. Cutting the bridge's full dict into
  shards and joining them gives it back, bit for bit.
* One update of each family (tiny conformer encoder with BatchNorm, two
  accumulated micro-steps, clip 1, dropout 0; the Paraformer glancing at
  ratio 0.75 with the global batch's noise handed over) at tp = 2, sp = 2,
  dp 2 x tp 2 and sp 2 x tp 2 against one process: in float64 the loss,
  every gradient leaf and the BatchNorm statistics within 1e-12 of the
  leaf's max, in fp32 within rtol 1e-4, atol 1e-6 (tests/test_torch_tp.py's
  bounds; a gradient's atol of the largest gradient, ``check_step``'s
  ``grad_atol_of_top``); the eval loss shares and the Paraformer's loss_ce / loss_mae sum
  to the one-process values, and its eval glance noise is the dp rank's
  rows of the global draw, equal across tp and sp peers.
* The train CLI of each family at tp = 2 and sp = 2 against the JAX
  package's dp = 4 x tp = 2 and dp = 4 x sp = 2 runs on its 8 CPU devices,
  after those are shown to equal its dp = 8 run (JAX's own tp and sp runs
  of these families are untested in its suite): the mean loss and the
  parameters after one epoch within rtol 2e-4, atol 2e-4. The Paraformer
  runs there at ``model.sample_ratio=0``: JAX's default rbg stream draws
  its glance noise otherwise under another mesh, and torch cannot replay
  JAX's draws, so the glancing positions are the one part left out (the
  layout steps above hold them, with the noise handed over).
* The train CLI with the valid, save_model and inference triggers, the
  transducer at tp = 2 and the Paraformer at sp = 2 (glancing at its
  default 0.75, from its own streams): the valid lines (the Paraformer's
  loss_ce and loss_mae among them) and error-rate lines are the
  one-process run's, the checkpoints have the one-process layout and
  values, and a run cut after one epoch, inside an accumulation, and
  resumed ends where the uninterrupted one does.
* A tp that does not divide a family's sharded widths raises; one that
  leaves a replicated width undivided does not.

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
from liteasr_tpu_torch.parallel import sharding
from test_torch_tp import (  # noqa: F401  (the fixture)
    ATOL, JAX_TOL, RTOL, _restore_prng_impl, check_fp64, check_step)

CPU = torch.device("cpu")
WIDTHS = {"rnnt": w.TD_TINY, "paraformer": w.PARA_TINY}
LAYOUTS = {  # id: (world, sp, tp)
    "tp2": (2, 1, 2), "sp2": (2, 2, 1), "dp2_tp2": (4, 1, 2), "sp2_tp2": (4, 2, 2)}


def _tiny_model(family):
    return w.build_case(family)[0]


# ----------------------------------------------------------------- rules

@pytest.mark.parametrize("family", w.TPSP_FAMILIES)
def test_rules_follow_jax_param_specs(family):
    from liteasr_tpu.parallel.sharding import param_specs
    from liteasr_tpu_torch.bridge import _flatten, _leaf_to_torch, _lstm_leaf, state_dict_to_flax

    variables = state_dict_to_flax(_tiny_model(family).state_dict())
    spec_of = dict(_flatten(param_specs(variables["params"])))
    sharded, replicated = set(), set()
    for path, arr in _flatten(variables["params"]):
        if _lstm_leaf(path):  # one gate of a packed LSTM leaf
            assert not tuple(spec_of[path]), path
            replicated.add(".".join(path[:-2]))
            continue
        key, _ = _leaf_to_torch(path, arr)
        dims = [i for i, a in enumerate(tuple(spec_of[path])) if a == "tp"]
        want = None if not dims else (1 - dims[0] if path[-1] == "kernel" and arr.ndim == 2
                                      else dims[0])
        got = sharding.shard_dim(key, arr.ndim)
        if re.search(r"conv\.(depthwise_conv|norm)\.", key):
            assert want is None and got == 0, key  # the GLU pairs' channels
        else:
            assert got == want, (key, spec_of[path], got)
        (sharded if got is not None else replicated).add(key.rpartition(".")[0])
    tails = {"rnnt": ("decoder.rnn_0.cell", "decoder.embed", "lin_enc", "lin_dec", "lin_jnt"),
             "paraformer": ("predictor.conv", "predictor.lin", "embed",
                            "decoder.linear_out")}[family]
    assert set(tails) <= replicated
    if family == "paraformer":  # the parallel decoder's layers as U2's decoder's
        assert {"decoder.layer_0.self_attn.linear_q", "decoder.layer_0.src_attn.linear_o",
                "decoder.layer_0.feed_forward.fc1"} <= sharded
    assert sum(k.startswith("encoder.") for k in sharded) > 10


@pytest.mark.parametrize("family", w.TPSP_FAMILIES)
def test_shards_join_to_the_bridge_dict(family):
    from liteasr_tpu_torch.bridge import flax_to_shard, flax_to_state_dict, state_dict_to_flax

    full = flax_to_state_dict(state_dict_to_flax(_tiny_model(family).state_dict()))
    shards = [sharding.shard_state_dict(full, r, 2) for r in range(2)]
    merged = sharding.merge_state_dicts(shards)
    assert merged.keys() == full.keys()
    for key, val in full.items():
        assert torch.equal(merged[key], val), key
        if sharding.shard_dim(key, val.dim()) is None:
            assert torch.equal(shards[1][key], val), key
    variables = state_dict_to_flax(full)
    for r in range(2):
        got = flax_to_shard(variables, r, 2)
        assert all(torch.equal(got[k], v) for k, v in shards[r].items())


@pytest.mark.parametrize("family", w.TPSP_FAMILIES)
def test_widths_tp_does_not_divide_raise(family):
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.parallel import mesh

    lay = mesh.Layout(1, 1, 2, 0, 0, 0)
    for key in sharding.TP_WIDTHS[type(_tiny_model(family)).__name__]:
        cfg = DotDict(WIDTHS[family], **{key: 3 if "heads" in key else 33})
        with pytest.raises(ValueError, match=f"does not divide model.{key}"):
            sharding.shard_model(_tiny_model(family), lay, cfg)
    # the widths of replicated modules need not divide
    odd = {"rnnt": dict(dec_units=21, joint_dim=25, dec_dim=17),
           "paraformer": dict(vocab_size=13)}[family]
    model = sharding.shard_model(_tiny_model(family), lay, DotDict(WIDTHS[family], **odd))
    assert model.tp_sharded


# --------------------------------------------------- steps against one

@pytest.fixture(scope="module")
def one_process():
    return {family: w.tpsp_family(family) for family in w.TPSP_FAMILIES}


def _ranks(tmp_path, family, world, sp, tp):
    addr = w.free_address()
    runs = w.launch([[sys.executable, w.WORKER, "tpsp", addr, str(world), str(r), str(sp),
                      str(tp), str(tmp_path / f"r{r}.pt"), "family", family]
                     for r in range(world)], timeout=180)
    for r, (code, text) in enumerate(runs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
    return [torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(world)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", w.TPSP_FAMILIES)
def test_layouts_equal_one_process(tmp_path, one_process, family, layout):
    world, sp, tp = LAYOUTS[layout]
    ranks = _ranks(tmp_path, family, world, sp, tp)
    ref = one_process[family]
    check_fp64([dict(r["fp64"], layout=r["layout"]) for r in ranks], ref["fp64"])
    check_step([dict(r["step"], layout=r["layout"]) for r in ranks], ref["step"],
               grad_atol_of_top=True)
    counts = ranks[0]["counts"]
    assert ("activation@tp" in counts) == (tp > 1) and ("gather@sp" in counts) == (sp > 1)

    # eval: the dp x sp shares of one tp rank sum to the one-process values
    lead = [r["eval"] for r in ranks if r["layout"].tp_i == 0]
    for key in ["loss"] + sorted(ref["eval"]["aux"]):
        got = sum(e["loss"] if key == "loss" else e["aux"][key] for e in lead)
        want = ref["eval"]["loss"] if key == "loss" else ref["eval"]["aux"][key]
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=key)
    if family == "paraformer":  # the dp rank's rows of the global eval draw
        for r in ranks:
            lay = r["layout"]
            rows = slice(lay.dp_i * w.B // lay.dp, (lay.dp_i + 1) * w.B // lay.dp)
            assert torch.equal(r["eval"]["noise"], ref["eval"]["noise"][rows])
        assert set(ref["eval"]["aux"]) == {"loss_ce", "loss_mae"}


# ------------------------------------------------------ the train CLI

def _family_overrides(family, corpus, out, optimizer="my_adam"):
    """The transducer's or the Paraformer's tiny config (a conformer encoder
    of 1 layer, 2 heads; dropout 0; Adam, eps 1e-3: the zero-gradient conv
    bias in front of train-mode BatchNorm)."""
    base = [
        "task=asr", f"optimizer={optimizer}", "optimizer.lr=1e-3", "optimizer.eps=1e-3",
        f"task.vocab={corpus / 'vocab.txt'}", f"task.train={corpus / 'train'}",
        f"task.valid={corpus / 'valid'}", f"task.save_dir={out / 'ckpts'}",
        f"common.run_dir={out}", "model.enc_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.enc_attn_heads=2", "model.dropout_rate=0.0",
        "dataset.pad_time_multiple=64", "dataset.pad_label_multiple=8",
        "dataset.num_workers=1", "postprocess.workflow=[]",
        "optimization.clip_grad_norm=5.0"]
    if family == "rnnt":
        return base + ["model=my_transducer", "criterion=my_rnnt", "model.enc_arch=conformer",
                       "model.dec_layers=1", "model.dec_dim=16", "model.dec_units=32",
                       "model.joint_dim=32"]
    return base + ["model=Paraformer", "criterion=paraformer_loss", "model.dec_layers=1",
                   "model.dec_dim=32", "model.dec_ff_dim=64", "model.dec_attn_heads=2"]


@pytest.fixture(scope="module")
def corpus16(tmp_path_factory):
    """tiny_corpus's layout with 16 train utterances: two full batches of
    8, so that no layout pads a batch with dummy rows (JAX's BatchNorm
    counts a dummy row's frames, so a batch of 4 padded to dp = 8 rows
    normalizes otherwise than at dp = 4)."""
    from liteasr_tpu.data import kaldi_io

    root = tmp_path_factory.mktemp("corpus16")
    rng = np.random.default_rng(16)
    tokens = ["<unk>"] + [chr(ord("a") + i) for i in range(26)] + ["<space>"]
    (root / "vocab.txt").write_text("".join(f"{t} {i + 1}\n" for i, t in enumerate(tokens)))
    for split, n in (("train", 16), ("valid", 4)):
        d = root / split
        d.mkdir()
        mats, texts, frames = {}, [], []
        for i in range(n):
            t, uttid = int(rng.integers(20, 60)), f"{split}_utt{i:03d}"
            mats[uttid] = rng.normal(size=(t, 16)).astype(np.float32)
            word = "".join(chr(ord("a") + int(c))
                           for c in rng.integers(0, 26, int(rng.integers(3, 8))))
            texts.append(f"{uttid} {word}")
            frames.append(f"{uttid} {t}")
        kaldi_io.save_ark(str(d / "feats.ark"), mats, scp_path=str(d / "feats.scp"))
        (d / "utt2num_frames").write_text("\n".join(frames) + "\n")
        (d / "text").write_text("\n".join(texts) + "\n")
    return root


def _jax_cli(family, corpus, out, **dist):
    extra = ["model.sample_ratio=0.0"] if family == "paraformer" else []
    return (_family_overrides(family, corpus, out) + extra
            + ["dataset.batch_size=8", "optimization.max_epoch=1",
               "optimization.accum_grad=1", "common.trigger=[]"]
            + [f"distributed.{k}={v}" for k, v in dist.items()])


@pytest.mark.parametrize("family", w.TPSP_FAMILIES)
def test_train_cli_matches_the_jax_tp_and_sp_runs(corpus16, tmp_path, family):
    """JAX at dp = 8, dp = 4 x tp = 2 and dp = 4 x sp = 2; the port at tp = 2
    and sp = 2 (2 processes each), from the JAX run's init, started as soon
    as that init exists."""
    import liteasr_tpu.trainer as jtrainer
    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu.parallel import mesh as jmesh
    from liteasr_tpu.train import train as jax_train
    from liteasr_tpu_torch.bridge import flax_to_state_dict

    init, procs = tmp_path / "init.pt", {}
    run = jtrainer.Trainer.run

    def capture(self):
        if not procs:
            st = jax.device_get(self.state)
            torch.save(flax_to_state_dict({"params": st.params,
                                           "batch_stats": st.batch_stats}), init)
            for name, dist in (("tp", "distributed.tp=2"), ("sp", "distributed.sp=2")):
                addr = w.free_address()
                procs[name] = w.start([[
                    sys.executable, w.WORKER, "train", str(init),
                    *_jax_cli(family, corpus16, tmp_path / name), dist,
                    "common.trigger=[{name: save_model, interval: 1, unit: epoch}]",
                    f"distributed.coordinator_address={addr}", "distributed.num_processes=2",
                    f"distributed.process_id={r}"] for r in (0, 1)])
        return run(self)

    jax_runs = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtrainer.Trainer, "run", capture)
            for name, dist in (("dp", dict(dp=8)), ("tp", dict(dp=4, tp=2)),
                               ("sp", dict(dp=4, sp=2))):
                jmesh._MESH = None
                jax_runs[name] = jax_train(jax_compose(
                    _jax_cli(family, corpus16, tmp_path / f"jax_{name}", **dist)))
        outs = {name: [w.wait(p, 180) for p in ps] for name, ps in procs.items()}
    finally:
        jmesh._MESH = None
        for ps in procs.values():
            for p in ps:
                p.kill()

    def jax_result(trainer):
        st = jax.device_get(trainer.state)
        return (np.asarray(jax.device_get(trainer._loss_accum)),
                flax_to_state_dict({"params": st.params, "batch_stats": st.batch_stats}))

    ref_loss, ref_params = jax_result(jax_runs["dp"])
    for name in ("tp", "sp"):
        loss, params = jax_result(jax_runs[name])  # JAX's layout against its dp run
        np.testing.assert_allclose(loss, ref_loss, rtol=JAX_TOL, atol=JAX_TOL)
        for key, val in ref_params.items():
            np.testing.assert_allclose(params[key].numpy(), val.numpy(), rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=f"JAX {name} {key}")
        losses = []
        for r, (code, text) in enumerate(outs[name]):
            assert code == 0, f"{name} rank {r} failed:\n{text[-4000:]}"
            losses.append(json.loads(re.search(r"DP_WORKER_LOSSES (.*)", text).group(1)))
        if name == "tp":  # tp peers hold the whole loss
            assert losses[0] == losses[1]
            port_loss = np.mean(losses[0])
        else:  # the sp ranks' losses are shares of the global batch's
            port_loss = np.mean(np.sum(losses, axis=0))
        np.testing.assert_allclose(port_loss, loss.mean(), rtol=JAX_TOL, atol=JAX_TOL)
        ckpt = torch.load(tmp_path / name / "ckpts" / "model.ep.1.pt", weights_only=True)
        for key, val in params.items():
            np.testing.assert_allclose(ckpt[key].numpy(), val.numpy(), rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=f"port {name} {key}")


def _cli(family, corpus, out, epochs):
    mode = "transducer_greedy" if family == "rnnt" else "ctc_greedy"
    return _family_overrides(family, corpus, out) + [
        f"task.test=[{corpus / 'test'}]", "dataset.batch_size=4",
        "common.trigger=[{name: valid, interval: 1, unit: epoch}, "
        "{name: save_model, interval: 1, unit: epoch}, "
        "{name: inference, interval: 1, unit: epoch}]",
        f"optimization.max_epoch={epochs}", "optimization.accum_grad=2",
        f"inference.mode={mode}", "inference.batch_size=3"]


def _pair(family, corpus, out, epochs, dist, extra=()):
    addr = w.free_address()
    return [[sys.executable, "-m", "liteasr_tpu_torch.train", "--device", "cpu",
             *_cli(family, corpus, out, epochs), *extra, dist,
             f"distributed.coordinator_address={addr}", "distributed.num_processes=2",
             f"distributed.process_id={r}"] for r in (0, 1)]


def _lines(path, what):
    return [re.search(rf"\d+ / \S+ iters, .*{what}.*", ln).group(0).strip()
            for ln in path.read_text().splitlines() if what in ln]


@pytest.mark.parametrize("family,layout", [("rnnt", "tp"), ("paraformer", "sp")])
def test_train_cli_triggers_and_resume(tiny_corpus, tmp_path, family, layout):
    """2 epochs, and 1 epoch + a resume to 2, in ``layout`` (tp = 2 or sp =
    2), against one process. The cut falls between the two micro-steps of
    an accumulation (3 micro-batches an epoch, accum 2)."""
    from liteasr_tpu_torch import train

    dist = f"distributed.{layout}=2"
    procs = w.start(_pair(family, tiny_corpus, tmp_path / layout, 2, dist)
                    + _pair(family, tiny_corpus, tmp_path / "cut", 1, dist))
    try:
        trainer = train.main(_cli(family, tiny_corpus, tmp_path / "one", 2), device=CPU)
        outs = [w.wait(p, 180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"process {r} failed:\n{text[-4000:]}"
    outs = w.launch(_pair(family, tiny_corpus, tmp_path / "cut", 2, dist,
                          ["common.resume=auto"]), timeout=180)
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"resumed rank {r} failed:\n{text[-4000:]}"

    one = tmp_path / "one"
    for what in ("valid loss:", "test error rate:"):
        ref = _lines(one / "train.log", what)
        assert len(ref) == 2, ref
        assert _lines(tmp_path / layout / "train.log", what) == ref, what
    if family == "paraformer":
        assert all("| loss_ce:" in ln for ln in _lines(one / "train.log", "valid loss:"))
    for epoch in (1, 2):
        want = torch.load(one / "ckpts" / f"model.ep.{epoch}.pt", weights_only=True)
        got = torch.load(tmp_path / layout / "ckpts" / f"model.ep.{epoch}.pt",
                         weights_only=True)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        for key, val in want.items():
            np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"epoch {epoch} {key}")
    whole = torch.load(tmp_path / layout / "ckpts" / "model.ep.2.pt", weights_only=True)
    resumed = torch.load(tmp_path / "cut" / "ckpts" / "model.ep.2.pt", weights_only=True)
    for key, val in whole.items():  # resumed == uninterrupted, in the same layout
        np.testing.assert_allclose(resumed[key].numpy(), val.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    trainer.model.load_state_dict(whole, strict=True)  # into the port at tp = sp = 1
    state = torch.load(tmp_path / layout / "ckpts" / "train_state.pt", weights_only=True)
    assert len(state["rng_ranks"]) == 2
    if family == "paraformer":  # tp and sp peers share the dp rank's glance stream
        assert torch.equal(state["rng_ranks"][0]["glance"], state["rng_ranks"][1]["glance"])
        assert torch.equal(state["rng_ranks"][0]["glance"],
                           trainer.model.glance_generator.get_state())
