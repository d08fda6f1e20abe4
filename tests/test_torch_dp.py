"""Data-parallel training and decoding through the port's CLIs on the CPU:
2 processes in a gloo group against 1 process, and against the JAX package.

* U2 (a tiny conformer: BatchNorm on), ``task=synthetic``, dropout 0, Adam
  with amsgrad, accum 2, clip 5, one epoch: the 2-rank run's master
  checkpoint equals a 1-process port run (rtol 1e-4, atol 1e-6, as
  tests/test_multiprocess.py holds JAX's multi-process run) and the JAX
  package's ``train`` at dp=-1 over its 8 CPU devices (rtol 1e-4, atol
  1e-5: test_torch_train.py's step parity), all three from the JAX run's
  init. Adam's eps is 1e-3, as in that step parity: the conv bias in front
  of train-mode BatchNorm has a gradient that is 0 up to rounding, which a
  small eps would normalize to +-lr. Only the master writes files; both
  ranks log the valid line the 1-process run logs.
* The transducer (conformer encoder; Adam, eps 1e-3 for the same reason)
  through ``python -m liteasr_tpu_torch.train --device cpu`` in 2
  processes against 1.
* ``infer_dataset`` in 2 processes (rows padded to a multiple of 2 with
  dummy rows, each rank decoding its block) against 1: the same
  hypotheses, error count and decode order on both ranks.

Every subprocess runs under a hard 180 s limit (torch_dp_worker.launch)."""

import json
import re
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as w

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _restore_prng_impl():
    """The JAX Trainer sets the process-global PRNG implementation and never
    restores it (liteasr_tpu/trainer.py:172-174); put it back."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def _u2_overrides(out):
    return [
        "task=synthetic", "model=my_U2", "criterion=my_hybrid_ctc",
        "optimizer=my_adam", "optimizer.amsgrad=true", "optimizer.eps=1e-3",
        f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
        f"common.results_file={out / 'results.jsonl'}",
        "task.train_batches=4", "task.valid_batches=2", "task.batch_size=8",
        "task.time=64", "task.feat_dim=16", "task.label_len=8", "task.vocab_size=32",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "model.enc_attn_heads=2", "model.dec_attn_heads=2", "model.dropout_rate=0.0",
        "dataset.num_workers=1", "postprocess.workflow=[]",
        "optimization.max_epoch=1", "optimization.accum_grad=2",
        "optimization.clip_grad_norm=5.0"]


def _dist(addr, rank):
    return [f"distributed.coordinator_address={addr}", "distributed.num_processes=2",
            f"distributed.process_id={rank}"]


def _valid_lines(text):
    """The valid lines' messages, from train.log or the console."""
    return [re.search(r"\d+ / \S+ iters, .*valid loss:.*", ln).group(0).strip()
            for ln in text.splitlines() if "valid loss:" in ln]


@pytest.fixture(scope="module")
def u2_runs(tmp_path_factory):
    """The JAX run (its init saved as a port state dict), the 2-rank port
    run (started as soon as that init exists) and the 1-process port run."""
    import liteasr_tpu.trainer as jtrainer
    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu.train import setup_logging as jax_setup_logging
    from liteasr_tpu.train import train as jax_train
    from liteasr_tpu_torch import train
    from liteasr_tpu_torch.bridge import flax_to_state_dict
    from liteasr_tpu_torch.tasks import LiteasrTask

    root = tmp_path_factory.mktemp("dp_u2")
    dirs = {k: root / k for k in ("jax", "one", "r0", "r1")}
    init = root / "init.pt"
    addr = w.free_address()
    started = {}
    jax_run = jtrainer.Trainer.run

    def run(self):  # the JAX trainer's initial state, then its run
        st = jax.device_get(self.state)
        torch.save(flax_to_state_dict({"params": st.params,
                                       "batch_stats": st.batch_stats}), init)
        started["ranks"] = _start_ranks()
        return jax_run(self)

    def _start_ranks():
        return w.start([[sys.executable, w.WORKER, "train", str(init),
                         *_u2_overrides(dirs[f"r{r}"]), *_dist(addr, r)] for r in (0, 1)])

    build = LiteasrTask.build_model

    def build_model(self, cfg, device=None, generator=None):
        model = build(self, cfg, device=device, generator=generator)
        model.load_state_dict(torch.load(init, weights_only=True), strict=True)
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer.Trainer, "run", run)
        cfg = jax_compose(_u2_overrides(dirs["jax"]) + ["distributed.dp=-1"])
        jax_setup_logging(str(dirs["jax"]))
        jax_train(cfg)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(LiteasrTask, "build_model", build_model)
            one = train.main(_u2_overrides(dirs["one"]), device=CPU)
        outs = [w.wait(p, 180) for p in started["ranks"]]
    finally:
        for p in started.get("ranks", []):
            p.kill()
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
        assert f"DP_WORKER_DONE rank={r} world=2 step=4 backend=gloo" in text, text[-2000:]
    return dict(dirs=dirs, one=one, outs=[t for _, t in outs])


def _ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_two_ranks_train_as_one_process(u2_runs):
    dirs = u2_runs["dirs"]
    mp, sp = _ckpt(dirs["r0"] / "ckpts" / "model.ep.1.pt"), _ckpt(dirs["one"] / "ckpts" / "model.ep.1.pt")
    assert set(mp) == set(sp)
    init = _ckpt(dirs["r0"].parent / "init.pt")
    moved = [k for k in sp if not torch.equal(sp[k], init[k])]
    assert len(moved) > len(sp) // 2
    for key in sp:  # parameters and BatchNorm's running statistics
        np.testing.assert_allclose(mp[key].numpy(), sp[key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert int(u2_runs["one"].tx.count) == 2 and u2_runs["one"].tx.amsgrad


def test_port_trains_as_the_jax_dp_run(u2_runs):
    """The 1-process and the 2-rank port runs against liteasr_tpu.train at
    dp=-1 (8 CPU devices), optimizer=adam optimizer.amsgrad=true."""
    from liteasr_tpu import checkpoint as jckpt
    from liteasr_tpu_torch.bridge import flax_to_state_dict

    dirs = u2_runs["dirs"]
    ref = flax_to_state_dict(jckpt.load_params(str(dirs["jax"] / "ckpts" / "model.ep.1.msgpack")))
    for run in ("one", "r0"):
        got = _ckpt(dirs[run] / "ckpts" / "model.ep.1.pt")
        assert set(ref) <= set(got) and any("running_mean" in k for k in ref)
        for key, val in ref.items():
            np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{run} {key}")


def test_only_the_master_writes(u2_runs):
    dirs = u2_runs["dirs"]
    written = sorted(p.relative_to(dirs["r0"]).as_posix()
                     for p in dirs["r0"].rglob("*") if p.is_file())
    assert written == ["ckpts/model.ep.1.pt", "ckpts/train_state.pt",
                       "ckpts/train_state.pt.meta", "config.yaml", "results.jsonl",
                       "train.log"], written
    assert not [p for p in dirs["r1"].rglob("*") if p.is_file()]
    state = torch.load(dirs["r0"] / "ckpts" / "train_state.pt", weights_only=True)
    assert len(state["rng_ranks"]) == 2 and state["optimizer"]["nu_max"] is not None
    assert not torch.equal(state["rng_ranks"][0]["cpu"], state["rng_ranks"][1]["cpu"])


def test_ranks_log_the_one_process_valid_line(u2_runs):
    one = _valid_lines((u2_runs["dirs"]["one"] / "train.log").read_text())
    ranks = [_valid_lines(text) for text in u2_runs["outs"]]
    assert len(one) == 1 and "| ctc_infeasible:" in one[0]
    assert ranks[0] == ranks[1] == one
    assert ranks[0] == _valid_lines((u2_runs["dirs"]["r0"] / "train.log").read_text())


def _td_overrides(out):
    return [
        "task=synthetic", "model=my_transducer", "criterion=my_rnnt",
        "optimizer=my_adam", "optimizer.eps=1e-3",
        f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
        "task.train_batches=4", "task.valid_batches=1", "task.batch_size=6",
        "task.time=48", "task.feat_dim=16", "task.label_len=6", "task.vocab_size=12",
        "model.enc_arch=conformer", "model.enc_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.enc_attn_heads=2", "model.dec_dim=16",
        "model.dec_units=32", "model.dec_layers=1", "model.joint_dim=32",
        "model.dropout_rate=0.0",
        "dataset.num_workers=1", "postprocess.workflow=[]",
        "optimization.max_epoch=1", "optimization.accum_grad=2",
        "optimization.clip_grad_norm=5.0"]


def test_transducer_two_ranks_train_as_one_process(tmp_path):
    from liteasr_tpu_torch import train

    addr = w.free_address()
    procs = w.start([[sys.executable, "-m", "liteasr_tpu_torch.train", "--device", "cpu",
                      *_td_overrides(tmp_path / f"r{r}"), *_dist(addr, r)] for r in (0, 1)])
    try:
        one = train.main(_td_overrides(tmp_path / "one"), device=CPU)
        outs = [w.wait(p, 180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
    assert int(one.tx.count) == 2
    mp = _ckpt(tmp_path / "r0" / "ckpts" / "model.ep.1.pt")
    sp = _ckpt(tmp_path / "one" / "ckpts" / "model.ep.1.pt")
    assert set(mp) == set(sp) and any("running_mean" in k for k in sp)
    for key in sp:
        np.testing.assert_allclose(mp[key].numpy(), sp[key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert _valid_lines(outs[0][1]) == _valid_lines(outs[1][1]) == \
        _valid_lines((tmp_path / "one" / "train.log").read_text())


def _decode_overrides(corpus, out, dump):
    return [
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_noam",
        f"task.vocab={corpus / 'vocab.txt'}", f"task.train={corpus / 'train'}",
        f"task.valid={corpus / 'valid'}", f"task.test=[{corpus / 'test'}]",
        f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "inference.ckpt_name=1", "inference.model_avg=false",
        "inference.batch_size=3", "inference.beam_size=2", f"inference.dump={dump}"]


def test_dp_decode_equals_one_process(tiny_corpus, tmp_path):
    """4 test utterances in batches of 3: padded to 4 and 2 rows, rank 1's
    block of the second batch is all dummy rows."""
    from liteasr_tpu_torch import infer, tasks
    from liteasr_tpu_torch.config import compose

    base = _decode_overrides(tiny_corpus, tmp_path, tmp_path / "one.tsv")
    cfg = compose(base)
    task = tasks.setup_task(cfg.task)
    task.load_dataset("test", list(task.cfg.test), cfg.dataset, None)
    model = task.build_model(cfg.model, generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), tmp_path / "ckpts" / "model.ep.1.pt")

    addr = w.free_address()
    runs = w.launch([[sys.executable, w.WORKER, "decode", str(tmp_path / f"r{r}.json"),
                      *_decode_overrides(tiny_corpus, tmp_path, tmp_path / f"r{r}.tsv"),
                      *_dist(addr, r)] for r in (0, 1)], timeout=180)
    for r, (code, text) in enumerate(runs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
    one = infer.infer(cfg, device=CPU)
    ranks = [json.loads((tmp_path / f"r{r}.json").read_text()) for r in (0, 1)]
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["results"] == ranks[1]["results"] == [list(x) for x in one]
    pairs = (tmp_path / "one.tsv").read_text()
    assert len(pairs.splitlines()) == 4
    assert (tmp_path / "r0.tsv").read_text() == (tmp_path / "r1.tsv").read_text() == pairs


def _asr_overrides(corpus, out):
    return [
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_adam",
        "optimizer.eps=1e-3", f"task.vocab={corpus / 'vocab.txt'}",
        f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
        f"task.test=[{corpus / 'test'}]", f"task.save_dir={out / 'ckpts'}",
        f"common.run_dir={out}", "common.memory_save=true",
        "common.trigger=[{name: valid, interval: 1, unit: epoch}, "
        "{name: save_model, interval: 1, unit: epoch}, "
        "{name: inference, interval: 1, unit: epoch}]",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "model.dropout_rate=0.0", "dataset.batch_size=4", "dataset.num_workers=1",
        "postprocess.workflow=[]", "optimization.max_epoch=1",
        "optimization.accum_grad=2", "optimization.clip_grad_norm=5.0",
        "inference.mode=ctc_greedy", "inference.batch_size=3"]


def test_corpus_run_with_memory_save_and_inference(tiny_corpus, tmp_path):
    """A Kaldi corpus in 2 processes: the master stages the memory_save dump
    while the other rank waits on the barrier, the collator hands each rank
    its rows, and the inference trigger decodes on both ranks (the master
    logs); against 1 process on a copy of the corpus."""
    import shutil

    from liteasr_tpu_torch import train

    corpora = [tmp_path / "dp_corpus", tmp_path / "one_corpus"]
    for c in corpora:
        shutil.copytree(tiny_corpus, c)
    addr = w.free_address()
    procs = w.start([[sys.executable, "-m", "liteasr_tpu_torch.train", "--device", "cpu",
                      *_asr_overrides(corpora[0], tmp_path / f"r{r}"), *_dist(addr, r)]
                     for r in (0, 1)])
    try:
        train.main(_asr_overrides(corpora[1], tmp_path / "one"), device=CPU)
        outs = [w.wait(p, 180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (code, text) in enumerate(outs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
    assert (corpora[0] / "train" / ".dump").is_dir()
    mp = _ckpt(tmp_path / "r0" / "ckpts" / "model.ep.1.pt")
    sp = _ckpt(tmp_path / "one" / "ckpts" / "model.ep.1.pt")
    for key in sp:
        np.testing.assert_allclose(mp[key].numpy(), sp[key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    rates = [re.findall(r"test error rate: \d+ / \d+", (tmp_path / d / "train.log").read_text())
             for d in ("r0", "one")]
    assert len(rates[0]) == 1 and rates[0] == rates[1]
    assert "test error rate" not in outs[1][1]  # rank 1 decoded but did not log it
