"""The transducer through the CLIs on the CPU at tiny widths: a checkpoint
that the JAX training CLI wrote, with that run's config.yaml, decoded by the
port's infer in both modes as JAX decodes it; the port's own train CLI ->
infer CLI; and the recipe's generic parts (raw waves, device SpecAugment,
dropout, resume, checkpoint averaging) on a transducer."""

import jax
import pytest
import torch

from liteasr_tpu.config.core import DotDict as JaxDotDict

from test_torch_frontend import wav_corpus  # noqa: F401 (a fixture)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _restore_prng_impl():
    """The JAX Trainer sets the process-global PRNG implementation and never
    restores it (liteasr_tpu/trainer.py:172-174); put it back so that the
    tests after this file see what they saw before it."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def _jax_run(corpus, out):
    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu.train import setup_logging, train

    cfg = jax_compose([
        "task=asr", "model=my_transducer", "criterion=my_rnnt", "optimizer=my_adam",
        "optimizer.lr=1e-3", f"task.vocab={corpus / 'vocab.txt'}",
        f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
        f"task.test=[{corpus / 'test'}]", f"task.save_dir={out / 'ckpts'}",
        f"common.run_dir={out}", "model.enc_layers=1", "model.dec_layers=1",
        "model.enc_dim=32", "model.enc_ff_dim=64", "model.dec_dim=32",
        "model.dec_units=32", "model.joint_dim=32", "model.enc_attn_heads=2",
        "dataset.batch_size=8", "dataset.pad_time_multiple=64",
        "dataset.pad_label_multiple=8", "optimization.max_epoch=1",
        "optimization.accum_grad=1", "optimization.clip_grad_norm=5.0",
        "postprocess.workflow=[]"])
    setup_logging(str(out))
    train(cfg)


@pytest.fixture(scope="module")
def jax_run(tiny_corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_td")
    _jax_run(tiny_corpus, out)
    return out


@pytest.mark.parametrize("mode", ["transducer_greedy", "transducer_beam_search"])
def test_jax_checkpoint_decodes_as_jax_decodes_it(jax_run, mode):
    """model.ep.1.msgpack from the JAX training CLI, read through the JAX
    run's own config.yaml by the port's infer: the same hypothesis text for
    every test utterance as JAX's infer_dataset on the same checkpoint."""
    from liteasr_tpu import checkpoint as jckpt
    from liteasr_tpu.config.core import load_yaml as jax_load_yaml
    from liteasr_tpu.infer import infer_dataset as jax_infer_dataset
    from liteasr_tpu.models import build_model as jax_build_model
    from liteasr_tpu.tasks import setup_task as jax_setup_task
    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    dump = jax_run / f"port_{mode}.tsv"
    overrides = ["inference.ckpt_name=1", "inference.model_avg=false",
                 "inference.batch_size=3", "inference.beam_size=3",
                 f"inference.mode={mode}", f"inference.dump={dump}"]
    cfg = compose(overrides, base=load_yaml(str(jax_run / "config.yaml")))
    results = infer.infer(cfg, device=CPU)

    jcfg = JaxDotDict(jax_load_yaml(str(jax_run / "config.yaml")))
    jtask = jax_setup_task(jcfg.task)
    jtask.load_dataset("test", list(jtask.cfg.test), jcfg.dataset, None)
    jmodel = jax_build_model(jcfg.model, jtask)
    variables = jckpt.load_params(str(jax_run / "ckpts" / "model.ep.1.msgpack"))
    pairs = []
    ref = jax_infer_dataset(jtask, jmodel, variables, jtask.dataset("test")[0],
                            JaxDotDict(batch_size=3, beam_size=3, mode=mode),
                            verbose=False, collect=pairs)
    got = [line.rstrip("\n").split("\t")[1:] for line in dump.read_text().splitlines()]
    assert got == [list(p) for p in pairs]
    assert results == [tuple(ref)]


def _port_overrides(corpus, out):
    return [
        "task=asr", "model=my_transducer", "criterion=my_rnnt", "optimizer=my_noam",
        f"task.vocab={corpus / 'vocab.txt'}", f"task.train={corpus / 'train'}",
        f"task.valid={corpus / 'valid'}", f"task.test=[{corpus / 'test'}]",
        f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=16", "model.dec_units=24",
        "model.joint_dim=16", "dataset.batch_size=4", "dataset.num_workers=1",
        "postprocess.workflow=[]", "optimization.max_epoch=2",
        "optimization.accum_grad=2", "optimization.clip_grad_norm=5.0",
        "optimizer.warmup=10"]


def test_train_cli_then_infer_cli_in_both_modes(tiny_corpus, tmp_path):
    from liteasr_tpu_torch import infer, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    trainer = train.main(_port_overrides(tiny_corpus, tmp_path), device=CPU)
    assert type(trainer.model).__name__ == "Transducer"
    assert trainer.epoch == 2 and trainer.step == 6 and int(trainer.tx.count) == 3
    losses = torch.stack(trainer._loss_accum)
    assert bool(torch.isfinite(losses).all())
    log = (tmp_path / "train.log").read_text()
    assert log.count("valid loss:") == 2
    assert (tmp_path / "ckpts" / "model.ep.2.pt").is_file()
    trainer.inference()  # the `inference` trigger: the beam on task.test
    assert "test error rate:" in (tmp_path / "train.log").read_text()
    for mode in ("transducer_greedy", "transducer_beam_search"):
        cfg = compose(["inference.ckpt_name=2", "inference.model_avg=false",
                       "inference.batch_size=3", "inference.beam_size=3",
                       f"inference.mode={mode}"],
                      base=load_yaml(str(tmp_path / "config.yaml")))
        assert cfg.inference.expansions_per_frame == 5
        results = infer.infer(cfg, device=CPU)
        assert len(results) == 1 and results[0][1] > 0


def test_recipe_resume_and_averaging_run_the_transducer(wav_corpus, tmp_path):
    """Raw waves, device SpecAugment and dropout 0.1: 1 epoch + a resume
    ends where an uninterrupted 2-epoch run ends, and infer averages the
    two checkpoints."""
    from liteasr_tpu_torch import infer, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    def run(out, *extra):
        overrides = [o for o in _port_overrides(wav_corpus, out)
                     if not o.startswith(("postprocess", "optimization.max_epoch"))]
        return train.main(overrides + [
            "model.dropout_rate=0.1", "dataset.fbank=true", "dataset.num_mel_bins=16",
            "dataset.pad_time_multiple=1600", "dataset.max_len_in=10000",
            "postprocess.spec_aug.time_warp=3", "postprocess.spec_aug.freq_mask=4",
            "postprocess.spec_aug.time_mask=6", *extra], device=CPU)

    whole = run(tmp_path / "whole", "optimization.max_epoch=2")
    run(tmp_path / "split", "optimization.max_epoch=1")
    resumed = run(tmp_path / "split", "optimization.max_epoch=2", "common.resume=auto")
    assert resumed.spec_aug is not None and resumed.fbank_bins == 16
    assert (resumed.epoch, resumed.iter, resumed.step) == (whole.epoch, whole.iter, whole.step)
    ref = whole.model.state_dict()
    for name, val in resumed.model.state_dict().items():
        assert torch.equal(val, ref[name]), name
    cfg = compose(["inference.ckpt_name=2", "inference.model_avg=true",
                   "inference.avg_num=2", "inference.batch_size=3",
                   "inference.mode=transducer_greedy"],
                  base=load_yaml(str(tmp_path / "split" / "config.yaml")))
    results = infer.infer(cfg, device=CPU)
    assert len(results) == 1 and results[0][1] > 0
