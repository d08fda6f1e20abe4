"""liteasr_tpu_torch's training state on the CPU in fp32, tiny widths:
``common.resume`` continues the counters and the events and ends where an
uninterrupted run ends (the same parameters, at dropout 0 and at dropout
0.1 with raw-wave fbank and device SpecAugment on), a missing state starts
fresh and a foreign one raises; a rematerialized step equals the plain one
at dropout 0.1 (the rel-pos kernels' dropout seed drawn once) and the JAX
package's remat step at dropout 0; ``memory_save`` and ``profile_dir``
runs complete."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu.config.core import DotDict as JaxDotDict
from liteasr_tpu_torch.bridge import flax_to_state_dict
from liteasr_tpu_torch.config.core import DotDict

from test_torch_frontend import wav_corpus  # noqa: F401 (a fixture)
from test_torch_train import _batch, _cfg, _torch_batch
from test_torch_u2 import TINY, build_pair

CPU = torch.device("cpu")


def _overrides(corpus, out, *extra, raw_wave=False):
    base = [
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc",
        "optimizer=my_noam", f"task.vocab={corpus / 'vocab.txt'}",
        f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
        f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
        f"common.results_file={out / 'results.jsonl'}",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "dataset.batch_size=4", "dataset.num_workers=1",
        "optimization.accum_grad=2", "optimizer.warmup=10"]
    if raw_wave:
        base += ["dataset.fbank=true", "dataset.num_mel_bins=16",
                 "dataset.pad_time_multiple=1600", "dataset.max_len_in=10000",
                 "postprocess.spec_aug.time_warp=3", "postprocess.spec_aug.freq_mask=4",
                 "postprocess.spec_aug.time_mask=6"]
    return base + list(extra)


def _train(overrides):
    from liteasr_tpu_torch import train

    return train.main(overrides, device=CPU)


def _valid_epochs(out):
    return [int(line.split(" epochs - ")[0].split(", ")[-1].split(" / ")[0])
            for line in (out / "train.log").read_text().splitlines()
            if "valid loss:" in line]


def test_resume_continues_counters_and_events(tiny_corpus, tmp_path):
    """3 batches an epoch at accum 2: epoch 1 ends inside an accumulation
    window, which the state carries."""
    first = _train(_overrides(tiny_corpus, tmp_path, "postprocess.workflow=[]",
                              "optimization.max_epoch=1"))
    meta = json.loads((tmp_path / "ckpts" / "train_state.pt.meta").read_text())
    assert meta == {"iter": first.iter, "epoch": 1} and first.iter == 1
    assert first.tx.mini_step == 1  # one micro-step into the next window
    second = _train(_overrides(tiny_corpus, tmp_path, "postprocess.workflow=[]",
                               "optimization.max_epoch=3", "common.resume=auto"))
    assert (second.epoch, second.iter, second.step) == (3, 4, 9)
    assert int(second.tx.count) == 4
    assert _valid_epochs(tmp_path) == [1, 2, 3]  # no event repeats at the boundary
    for ep in (1, 2, 3):
        assert (tmp_path / "ckpts" / f"model.ep.{ep}.pt").is_file()
    rows = [json.loads(r) for r in (tmp_path / "results.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["run_meta", "valid", "run_meta", "valid", "valid"]
    assert rows[2]["resumed_from_iter"] == 1

    # the infer CLI on the config's defaults (model_avg=true, N-best by the
    # run's train.log) in attention mode
    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    cfg = compose(["inference.ckpt_name=3", "inference.avg_num=2",
                   "inference.mode=attention", "inference.beam_size=3",
                   f"task.test=[{tiny_corpus / 'test'}]"],
                  base=load_yaml(str(tmp_path / "config.yaml")))
    assert cfg.inference.model_avg and cfg.inference.avg_policy == str(tmp_path)
    results = infer.infer(cfg, device=CPU)
    assert len(results) == 1 and results[0][1] > 0
    assert "loading average checkpoint" in (tmp_path / "train.log").read_text()


def test_resume_without_a_state_starts_fresh_and_a_foreign_state_raises(
        tiny_corpus, tmp_path):
    fresh = _train(_overrides(tiny_corpus, tmp_path, "postprocess.workflow=[]",
                              "optimization.max_epoch=1", "common.resume=auto"))
    assert fresh.step == 3
    assert "not found; starting fresh" in (tmp_path / "train.log").read_text()
    with pytest.raises(RuntimeError, match="does not match this run's"):
        _train(_overrides(tiny_corpus, tmp_path, "postprocess.workflow=[]",
                          "optimization.max_epoch=2", "common.resume=auto",
                          "model.enc_ff_dim=48"))
    with pytest.raises(RuntimeError, match="accum_grad"):
        _train(_overrides(tiny_corpus, tmp_path, "postprocess.workflow=[]",
                          "optimization.max_epoch=2", "common.resume=auto",
                          "optimization.accum_grad=1"))


@pytest.mark.parametrize("case", ["feats_dropout0", "wave_dropout0.1_specaug"])
def test_one_epoch_plus_resume_equals_two_epochs(tiny_corpus, wav_corpus, tmp_path, case):
    raw = case.startswith("wave")
    corpus = wav_corpus if raw else tiny_corpus
    extra = (["model.dropout_rate=0.1"] if raw else ["postprocess.workflow=[]"])
    whole = _train(_overrides(corpus, tmp_path / "whole", *extra,
                              "optimization.max_epoch=2", raw_wave=raw))
    _train(_overrides(corpus, tmp_path / "split", *extra, "optimization.max_epoch=1",
                      raw_wave=raw))
    resumed = _train(_overrides(corpus, tmp_path / "split", *extra,
                                "optimization.max_epoch=2", "common.resume=auto",
                                raw_wave=raw))
    assert (resumed.epoch, resumed.iter, resumed.step) == (whole.epoch, whole.iter, whole.step)
    if raw:
        assert resumed.spec_aug is not None and resumed.fbank_bins == 16
    ref = whole.model.state_dict()
    for name, val in resumed.model.state_dict().items():
        assert torch.equal(val, ref[name]), name
    assert torch.equal(resumed.tx.mu, whole.tx.mu) and torch.equal(resumed.tx.nu, whole.tx.nu)
    assert _valid_epochs(tmp_path / "split") == _valid_epochs(tmp_path / "whole") == [1, 2]


def _remat_pair(dropout: float):
    from liteasr_tpu_torch.models.u2 import U2

    rates = {k: dropout for k in ("dropout_rate", "enc_dropout_rate", "enc_attn_dropout_rate",
                                  "enc_pos_dropout_rate", "enc_ff_dropout_rate",
                                  "dec_dropout_rate")}
    models = [U2(**TINY, **rates, remat=remat, generator=torch.Generator().manual_seed(0))
              for remat in (False, True)]
    models[1].load_state_dict(models[0].state_dict())
    return models


def _step(model, batch, seed):
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss

    torch.manual_seed(seed)
    model.seed_dropout(seed)
    loss, _ = HybridCTCLoss(DotDict(_cfg()))(model, batch, train=True)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_step_equals_the_plain_step_with_dropout():
    plain, remat = _remat_pair(0.1)
    batch = _torch_batch(_batch(8))
    p_loss, p_grads = _step(plain, batch, 3)
    r_loss, r_grads = _step(remat, batch, 3)
    assert r_loss == p_loss
    for name, g in p_grads.items():
        torch.testing.assert_close(r_grads[name], g, rtol=1e-6, atol=1e-7, msg=name)
    # the recompute drew no second seed and moved BatchNorm's statistics once
    assert torch.equal(remat.dropout_generator.get_state(), plain.dropout_generator.get_state())
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        assert torch.equal(a, b), name
    # and dropout did act: another seed gives another step
    other_loss, _ = _step(remat, batch, 4)
    assert other_loss != r_loss


def test_remat_step_matches_jax():
    """At dropout 0 the remat step equals the JAX package's remat step
    (loss and every gradient, tolerances of test_torch_train)."""
    from liteasr_tpu.criterions.hybrid_ctc_attn import HybridCTCLoss as JaxLoss
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss

    jmodel, variables, tmodel = build_pair(9, remat=True)
    assert tmodel.encoder.remat
    b = _batch(9)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jcrit = JaxLoss(JaxDotDict(_cfg()))

    def loss_fn(params):
        return jcrit(jmodel, {"params": params, "batch_stats": variables["batch_stats"]},
                     jb, rngs=None, train=True)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    loss, _ = HybridCTCLoss(DotDict(_cfg()))(tmodel, _torch_batch(b), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-5)
    ref = flax_to_state_dict({"params": jax.device_get(jgrads)})
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_memory_save_and_profile_dir_runs_complete(tiny_corpus, tmp_path):
    corpus = tmp_path / "corpus"  # memory_save stages into the train dir
    shutil.copytree(tiny_corpus, corpus)
    trainer = _train(_overrides(corpus, tmp_path / "run", "postprocess.workflow=[]",
                                "optimization.max_epoch=1", "common.memory_save=true",
                                f"common.profile_dir={tmp_path / 'prof'}"))
    assert (corpus / "train" / ".dump").is_dir()
    assert trainer.epoch == 1 and trainer.step == len(trainer.task.dataset("train")) == 3
    assert trainer.task.dataset("train").data == []  # batches are read from the dump
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
