"""Tensor and sequence parallelism for wav2vec 2.0 on the port
(``parallel.sharding.shard_model``), on the CPU over gloo, against one
process and against the JAX package's rules.

* The rules: for every leaf of the tiny model's flax tree the port shards
  the dim that ``liteasr_tpu.parallel.sharding.param_specs`` gives: the
  encoder layers' attention and FFN Megatron's way; the extractor, the
  quantizer, the projections, ``mask_emb`` and the positional conv stay
  replicated. Cutting the bridge's full dict into shards and joining them
  gives it back, bit for bit. A tp that does not divide the heads or the
  FFN width raises.
* One step (tests/torch_dp_worker.py ``tpsp ... family wav2vec``: the train
  draws are the dp rank's rows of one global draw, handed over; diversity
  weight 1; a weight-0 row) at tp = 2, sp = 2, dp 2 x tp 2 and sp 2 x tp 2
  against one process: in float64 the loss, accuracy and code_ppl (the
  dp x sp shares of a tp rank summed), every gradient leaf and the eval
  loss, accuracy and code_ppl (the model's own eval draws, keyed by the dp
  coordinate) within 1e-12 of the leaf's max; one FusedAdam update of two
  accumulated micro-steps, applied on both sides (no step skipped), in
  fp32 (FusedAdam keeps fp32 state) at tests/test_torch_tp.py's bounds.
* Planted faults fail that comparison: under tp the diversity term and
  code_ppl divided by the process count, under sp the positional conv's
  halo zeroed.
* The JAX package's own tiny wav2vec 2.0 run at dp = 4 x tp = 2 and dp = 4
  x sp = 2 on its 8 CPU devices against its dp = 8 run (its suite tests no
  wav2vec 2.0 layout): the same loss and parameters after one step, so its
  draws do not depend on the mesh (ROADMAP section 3).
* The train CLI at tp = 2 and sp = 2 against the port's one-process run
  (dropout 0, no dummy rows, every update applied): the valid lines and the
  checkpoints of each epoch; a run cut after one epoch, inside an
  accumulation, at sp = 2 and resumed ends where the uninterrupted one
  does.

Every subprocess runs under a hard 180 s limit (torch_dp_worker.launch).
"""

import re
import sys

import numpy as np
import pytest
import torch

import torch_dp_worker as w
from liteasr_tpu_torch.parallel import sharding
from test_torch_tp import (  # noqa: F401  (the fixture)
    ATOL, JAX_TOL, RTOL, _restore_prng_impl, check_fp64, check_step)

CPU = torch.device("cpu")
LAYOUTS = {  # id: (world, sp, tp)
    "tp2": (2, 1, 2), "sp2": (2, 2, 1), "dp2_tp2": (4, 1, 2), "sp2_tp2": (4, 2, 2)}
FP64_TOL = 1e-12


def _tiny_model():
    return w.build_case("wav2vec")[0]


# ----------------------------------------------------------------- rules

def test_rules_follow_jax_param_specs():
    from liteasr_tpu.parallel.sharding import param_specs
    from liteasr_tpu_torch.bridge import _flatten, _leaf_to_torch, state_dict_to_flax

    variables = state_dict_to_flax(_tiny_model().state_dict())
    spec_of = dict(_flatten(param_specs(variables["params"])))
    sharded, replicated = set(), set()
    for path, arr in _flatten(variables["params"]):
        key, _ = _leaf_to_torch(path, arr)
        dims = [i for i, a in enumerate(tuple(spec_of[path])) if a == "tp"]
        want = None if not dims else (1 - dims[0] if path[-1] == "kernel" and arr.ndim == 2
                                      else dims[0])
        got = sharding.shard_dim(key, arr.ndim)
        assert got == want, (key, spec_of[path], got)
        (sharded if got is not None else replicated).add(key.rpartition(".")[0])
    assert sharded == {f"encoder.layer_0.{m}" for m in (
        "self_attn.linear_q", "self_attn.linear_k", "self_attn.linear_v", "self_attn.linear_o",
        "feed_forward.fc1", "feed_forward.fc2")}
    assert {"feature_extractor.conv_0", "quantizer.weight_proj", "linear_input",
            "linear_quantizer", "linear_final", "encoder.pos_conv"} <= replicated


def test_shards_join_to_the_bridge_dict():
    from liteasr_tpu_torch.bridge import flax_to_shard, flax_to_state_dict, state_dict_to_flax

    full = flax_to_state_dict(state_dict_to_flax(_tiny_model().state_dict()))
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


def test_widths_tp_does_not_divide_raise():
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.parallel import mesh

    lay = mesh.Layout(1, 1, 2, 0, 0, 0)
    assert sharding.TP_WIDTHS["Wav2Vec2"] == ("encoder_attention_heads",
                                              "encoder_ffn_embed_dim")
    for key in sharding.TP_WIDTHS["Wav2Vec2"]:
        cfg = DotDict(w.W2V_TINY, **{key: 3 if "heads" in key else 33})
        with pytest.raises(ValueError, match=f"does not divide model.{key}"):
            sharding.shard_model(_tiny_model(), lay, cfg)
    # the replicated quantizer's widths need not divide
    model = sharding.shard_model(_tiny_model(), lay, DotDict(w.W2V_TINY, latent_vars=7))
    assert model.tp_sharded and not model.seq_parallel
    model = sharding.shard_model(_tiny_model(), mesh.Layout(1, 2, 1, 0, 0, 0),
                                 DotDict(w.W2V_TINY))
    assert model.seq_parallel and not getattr(model, "tp_sharded", False)


def test_sample_window_reads_the_frames_of_the_whole_wave():
    """The extractor over a block's sample window gives the whole wave's
    frames of the block, for every block of the default stack and of the
    tiny one."""
    from liteasr_tpu_torch.models.wav2vec2 import DEFAULT_CONV_LAYERS
    from liteasr_tpu_torch.nets.wav2vec2 import (
        ConvFeatureExtractor, conv_output_length, sample_window)

    gen = torch.Generator().manual_seed(3)
    for layers, S in ((eval(DEFAULT_CONV_LAYERS), 3 * 320 + 401),  # noqa: S307
                      (eval(w.W2V_TINY["conv_feature_layers"]), 960)):  # noqa: S307
        layers = [(4, k, s) for _, k, s in layers]
        ext = ConvFeatureExtractor(layers)
        wave = torch.randn(2, S, generator=gen)
        whole = ext(wave)
        F = conv_output_length(S, layers)
        assert whole.shape[1] == F
        for lo, hi in ((0, F), (0, 1), (1, F), (F // 2, F), (1, F - 1)):
            a, b = sample_window(lo, hi, layers)
            assert b <= S
            torch.testing.assert_close(ext(wave[:, a:b]), whole[:, lo:hi], rtol=0, atol=1e-5)
    assert sample_window(2, 5, eval(DEFAULT_CONV_LAYERS)) == (640, 4 * 320 + 400)  # noqa: S307


# --------------------------------------------------- steps against one

@pytest.fixture(scope="module")
def one_process():
    return w.tpsp_family("wav2vec")


def _ranks(tmp_path, world, sp, tp, family="wav2vec"):
    addr = w.free_address()
    runs = w.launch([[sys.executable, w.WORKER, "tpsp", addr, str(world), str(r), str(sp),
                      str(tp), str(tmp_path / f"r{r}.pt"), "family", family]
                     for r in range(world)], timeout=180)
    for r, (code, text) in enumerate(runs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
    return [torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(world)]


def check_w2v(ranks, ref):
    """fp64: the loss, every gradient and the statistics (check_fp64), then
    the train and eval aux and the eval loss, each the sum of the dp x sp
    shares of one tp rank, within FP64_TOL of the one-process value; fp32:
    the update (check_step), applied on every rank."""
    check_fp64([dict(r["fp64"], layout=r["layout"]) for r in ranks], ref["fp64"], FP64_TOL)
    lead = [r["fp64"] for r in ranks if r["layout"].tp_i == 0]
    for what in ("aux", "eval"):
        want = ref["fp64"][what]
        got = [x[what] for x in lead]
        if what == "eval":
            assert abs(sum(g["loss"] for g in got).item() - want["loss"].item()) <= (
                FP64_TOL * abs(want["loss"].item())), "eval loss"
            want, got = want["aux"], [g["aux"] for g in got]
        assert set(want) == {"accuracy", "code_ppl"}
        for key, val in want.items():
            assert abs(sum(g[key] for g in got).item() - val.item()) <= (
                FP64_TOL * abs(val.item())), f"{what} {key}"
    check_step([dict(r["step"], layout=r["layout"]) for r in ranks], ref["step"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_equal_one_process(tmp_path, one_process, layout):
    world, sp, tp = LAYOUTS[layout]
    ranks = _ranks(tmp_path, world, sp, tp)
    assert (one_process["step"]["count"], one_process["step"]["notfinite"]) == (1, 0)
    check_w2v(ranks, one_process)
    counts = ranks[0]["counts"]
    assert ("activation@tp" in counts) == (tp > 1) and ("gather@sp" in counts) == (sp > 1)
    assert counts["code_usage"] > 0


@pytest.mark.parametrize("fault,layout", [("diversity_world", "tp2"),
                                          ("pos_conv_halo", "sp2")])
def test_planted_faults_fail_the_comparison(tmp_path, one_process, fault, layout):
    world, sp, tp = LAYOUTS[layout]
    ranks = _ranks(tmp_path, world, sp, tp, f"wav2vec:{fault}")
    with pytest.raises(AssertionError):
        check_w2v(ranks, one_process)


# ------------------------------------------------------ the train CLI

def _write_waves(root, splits, lengths, seed=7):
    from liteasr_tpu_torch.data import kaldi_io

    rng = np.random.default_rng(seed)
    for split, n in splits:
        d = root / split
        d.mkdir()
        lines = []
        for i in range(n):
            p = str(d / f"u{i}.wav")
            kaldi_io.write_wav(p, (rng.normal(size=int(rng.integers(*lengths)))
                                   * 0.05).astype(np.float32))
            lines.append(f"{split}u{i} {p}")
        (d / "wav.scp").write_text("\n".join(lines) + "\n")
    return root


def test_jax_layouts_equal_its_dp_run(tmp_path):
    """JAX at dp = 8, dp = 4 x tp = 2 and dp = 4 x sp = 2 on 16 waves of
    8,000-9,000 samples (one batch of 16 rows: no dummy row at dp = 8)."""
    import jax

    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu.parallel import mesh as jmesh
    from liteasr_tpu.train import train as jax_train

    corpus = _write_waves(tmp_path, (("train", 16), ("valid", 8)), (8000, 9000))
    small = [f"model.{k}={v}" for k, v in w.W2V_TINY.items()]
    runs = {}
    try:
        for name, dist in (("dp", dict(dp=8)), ("tp", dict(dp=4, tp=2)),
                           ("sp", dict(dp=4, sp=2))):
            jmesh._MESH = None
            out = tmp_path / f"jax_{name}"
            trainer = jax_train(jax_compose([
                "task=pretrain", "model=wav2vec2", "criterion=wav2vec", "optimizer=my_adam",
                "optimizer.lr=1e-4", "optimizer.eps=1e-3", "criterion.diversity_weight=1.0",
                f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
                f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
                "optimization.max_epoch=1", "optimization.accum_grad=1",
                "dataset.pad_batch_multiple=1", "common.trigger=[]", *small]
                + [f"distributed.{k}={v}" for k, v in dist.items()]))
            runs[name] = (np.asarray(jax.device_get(trainer._loss_accum)),
                          jax.tree_util.tree_leaves(jax.device_get(trainer.state.params)))
    finally:
        jmesh._MESH = None
    loss, params = runs["dp"]
    assert loss.shape == (1,) and np.isfinite(loss).all()
    for name in ("tp", "sp"):
        np.testing.assert_array_equal(runs[name][0], loss, err_msg=name)
        for got, want in zip(runs[name][1], params):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=name)


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    """6 train and 2 valid waves of 1800-2600 samples
    (tests/test_torch_wav2vec2_cli.py's)."""
    return _write_waves(tmp_path_factory.mktemp("w2v_tp_wavs"), (("train", 6), ("valid", 2)),
                        (1800, 2600))


def _cli(corpus, out, epochs):
    """The tiny wav2vec 2.0 at dropout 0, one micro-batch of the 6 waves an
    epoch with no dummy row (a dummy row's zero-variance LayerNorms make a
    step at init non-finite), accum 2 (Adam eps 1e-3: the attention key
    bias's gradient is 0 in exact arithmetic)."""
    small = [f"model.{k}={v}" for k, v in w.W2V_TINY.items()]
    return ["task=pretrain", "model=wav2vec2", "criterion=wav2vec", "optimizer=my_adam",
            "optimizer.lr=1e-3", "optimizer.eps=1e-3", "criterion.diversity_weight=1.0",
            f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
            f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
            f"optimization.max_epoch={epochs}", "optimization.accum_grad=2",
            "optimization.clip_grad_norm=5.0", "dataset.num_workers=1",
            "dataset.pad_batch_multiple=1",
            "common.trigger=[{name: valid, interval: 1, unit: epoch}, "
            "{name: save_model, interval: 1, unit: epoch}]", *small]


def _pair(corpus, out, epochs, dist, extra=()):
    addr = w.free_address()
    return [[sys.executable, "-m", "liteasr_tpu_torch.train", "--device", "cpu",
             *_cli(corpus, out, epochs), *extra, dist,
             f"distributed.coordinator_address={addr}", "distributed.num_processes=2",
             f"distributed.process_id={r}"] for r in (0, 1)]


def _valid_lines(path):
    return [re.search(r"\d+ / \S+ iters, .*valid loss:.*", ln).group(0).strip()
            for ln in (path / "train.log").read_text().splitlines() if "valid loss:" in ln]


def test_train_cli_at_tp_and_sp_and_resume(wav_corpus, tmp_path):
    """3 epochs at tp = 2 and at sp = 2 against one process; at sp = 2 also 1
    epoch (the cut falls inside an accumulation of 2) and a resume to 3,
    against the uninterrupted sp = 2 run."""
    from liteasr_tpu_torch import train

    procs = w.start(_pair(wav_corpus, tmp_path / "tp", 3, "distributed.tp=2")
                    + _pair(wav_corpus, tmp_path / "sp", 3, "distributed.sp=2")
                    + _pair(wav_corpus, tmp_path / "cut", 1, "distributed.sp=2"))
    try:
        trainer = train.main(_cli(wav_corpus, tmp_path / "one", 3), device=CPU)
        outs = [w.wait(p, 180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"process {r} failed:\n{text[-4000:]}"
    outs = w.launch(_pair(wav_corpus, tmp_path / "cut", 3, "distributed.sp=2",
                          ["common.resume=auto"]), timeout=180)
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"resumed rank {r} failed:\n{text[-4000:]}"
    assert trainer.step == 3 and int(trainer.tx.count) == 1
    assert int(trainer.tx.notfinite_count) == 0  # the update applied

    one = tmp_path / "one"
    ref = _valid_lines(one)
    assert len(ref) == 3 and all("| accuracy:" in v and "| code_ppl:" in v for v in ref)
    for layout in ("tp", "sp"):
        assert _valid_lines(tmp_path / layout) == ref, layout
        for epoch in (1, 2, 3):
            want = torch.load(one / "ckpts" / f"model.ep.{epoch}.pt", weights_only=True)
            got = torch.load(tmp_path / layout / "ckpts" / f"model.ep.{epoch}.pt",
                             weights_only=True)
            assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
            for key, val in want.items():
                np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{layout} epoch {epoch} {key}")
    whole = torch.load(tmp_path / "sp" / "ckpts" / "model.ep.3.pt", weights_only=True)
    resumed = torch.load(tmp_path / "cut" / "ckpts" / "model.ep.3.pt", weights_only=True)
    for key, val in whole.items():  # resumed == uninterrupted, in the same layout
        np.testing.assert_allclose(resumed[key].numpy(), val.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert _valid_lines(tmp_path / "cut")[-1] == ref[-1]
    state = torch.load(tmp_path / "sp" / "ckpts" / "train_state.pt", weights_only=True)
    assert len(state["rng_ranks"]) == 2
    for key in ("mask", "negatives", "gumbel"):  # sp peers share the dp rank's draws
        assert torch.equal(state["rng_ranks"][0][key], state["rng_ranks"][1][key])
        assert torch.equal(state["rng_ranks"][0][key],
                           getattr(trainer.model, f"{key}_generator").get_state())
