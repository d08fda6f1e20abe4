"""The Paraformer through the CLIs on the CPU at tiny widths: a checkpoint that
the JAX training CLI wrote (tests/test_infer_families.py's overrides), with
that run's config.yaml, decoded by the port's infer to JAX's hypotheses;
the port's own train CLI -> infer CLI, with the micro-step count that the
criterion sees and the glance generator's resume state."""

import jax
import pytest
import torch

from liteasr_tpu.config.core import DotDict as JaxDotDict

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _restore_prng_impl():
    """The JAX Trainer sets the process-global PRNG implementation and never
    restores it (liteasr_tpu/trainer.py:172-174); put it back so that the
    tests after this file see what they saw before it."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


@pytest.fixture(scope="module")
def jax_run(tiny_corpus, tmp_path_factory):
    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu.train import setup_logging, train

    out = tmp_path_factory.mktemp("jax_para")
    cfg = jax_compose([
        "task=asr", "model=Paraformer", "criterion=paraformer_loss", "optimizer=my_adam",
        "optimizer.lr=1e-3", "model.enc_layers=1", "model.dec_layers=1",
        "model.enc_dim=32", "model.enc_ff_dim=64", "model.dec_dim=32",
        "model.dec_ff_dim=64", "model.enc_attn_heads=2", "model.dec_attn_heads=2",
        f"task.vocab={tiny_corpus / 'vocab.txt'}", f"task.train={tiny_corpus / 'train'}",
        f"task.valid={tiny_corpus / 'valid'}", f"task.test=[{tiny_corpus / 'test'}]",
        f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
        "dataset.batch_size=8", "dataset.pad_time_multiple=64",
        "dataset.pad_label_multiple=8", "optimization.max_epoch=1",
        "optimization.accum_grad=1", "optimization.clip_grad_norm=5.0",
        "postprocess.workflow=[]"])
    setup_logging(str(out))
    train(cfg)
    return out


def test_jax_checkpoint_decodes_as_jax_decodes_it(jax_run):
    """model.ep.1.msgpack from the JAX training CLI (the predictor's 1-D conv
    kernel among its leaves), read through the JAX run's own config.yaml by
    the port's infer: the same hypothesis text for every test utterance as
    JAX's infer_dataset on the same checkpoint."""
    from liteasr_tpu import checkpoint as jckpt
    from liteasr_tpu.config.core import load_yaml as jax_load_yaml
    from liteasr_tpu.infer import infer_dataset as jax_infer_dataset
    from liteasr_tpu.models import build_model as jax_build_model
    from liteasr_tpu.tasks import setup_task as jax_setup_task
    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    dump = jax_run / "port.tsv"
    cfg = compose(["inference.ckpt_name=1", "inference.model_avg=false",
                   "inference.batch_size=3", f"inference.dump={dump}"],
                  base=load_yaml(str(jax_run / "config.yaml")))
    assert cfg.model.name == "Paraformer" and cfg.model.glance_at_eval is True
    results = infer.infer(cfg, device=CPU)

    jcfg = JaxDotDict(jax_load_yaml(str(jax_run / "config.yaml")))
    jtask = jax_setup_task(jcfg.task)
    jtask.load_dataset("test", list(jtask.cfg.test), jcfg.dataset, None)
    jmodel = jax_build_model(jcfg.model, jtask)
    variables = jckpt.load_params(str(jax_run / "ckpts" / "model.ep.1.msgpack"))
    assert variables["params"]["predictor"]["conv"]["kernel"].ndim == 3
    pairs = []
    ref = jax_infer_dataset(jtask, jmodel, variables, jtask.dataset("test")[0],
                            JaxDotDict(batch_size=3),
                            pad_time_multiple=jcfg.dataset.pad_time_multiple,
                            verbose=False, collect=pairs)
    got = [line.rstrip("\n").split("\t")[1:] for line in dump.read_text().splitlines()]
    assert got == [list(p) for p in pairs]
    assert results == [tuple(ref)]


def _port_overrides(corpus, out):
    return [
        "task=asr", "model=Paraformer", "criterion=paraformer_loss", "optimizer=my_noam",
        f"task.vocab={corpus / 'vocab.txt'}", f"task.train={corpus / 'train'}",
        f"task.valid={corpus / 'valid'}", f"task.test=[{corpus / 'test'}]",
        f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
        "model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "model.enc_attn_heads=2", "model.dec_attn_heads=2", "model.dropout_rate=0.1",
        "model.sample_ratio_end=0.0", "model.sample_ratio_decay_steps=4",
        "dataset.batch_size=4", "dataset.num_workers=1", "postprocess.workflow=[]",
        "optimization.max_epoch=2", "optimization.accum_grad=2",
        "optimization.clip_grad_norm=5.0", "optimizer.warmup=10"]


def test_train_cli_then_infer_cli(tiny_corpus, tmp_path, monkeypatch):
    """train.main (2 epochs, accum 2, the glancing schedule on) writes
    ``valid loss:`` lines and model.ep.2.pt, which infer decodes with the
    run's config.yaml; each train micro-step's criterion sees the
    micro-steps taken before it (0 first, as JAX's ``batch["step"] =
    state.step``), validation none; the resume state holds the glance
    generator."""
    from liteasr_tpu_torch import infer, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml
    from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss
    from liteasr_tpu_torch.trainer import TRAIN_STATE

    seen = []
    call = ParaformerLoss.__call__

    def record(self, model, batch, train=True):
        seen.append((train, batch.get("step")))
        return call(self, model, batch, train)

    monkeypatch.setattr(ParaformerLoss, "__call__", record)
    trainer = train.main(_port_overrides(tiny_corpus, tmp_path), device=CPU)
    assert type(trainer.model).__name__ == "Paraformer"
    assert trainer.epoch == 2 and trainer.step == 6 and int(trainer.tx.count) == 3
    assert [s for tr, s in seen if tr] == list(range(6))
    assert {s for tr, s in seen if not tr} == {None}
    assert bool(torch.isfinite(torch.stack(trainer._loss_accum)).all())
    log = (tmp_path / "train.log").read_text()
    assert log.count("valid loss:") == 2
    assert (tmp_path / "ckpts" / "model.ep.2.pt").is_file()
    state = torch.load(tmp_path / "ckpts" / TRAIN_STATE, weights_only=True)
    assert torch.equal(state["rng"]["glance"], trainer.model.glance_generator.get_state())
    trainer.inference()  # the `inference` trigger: CIF decode of task.test
    assert "test error rate:" in (tmp_path / "train.log").read_text()

    cfg = compose(["inference.ckpt_name=2", "inference.model_avg=false",
                   "inference.batch_size=3"], base=load_yaml(str(tmp_path / "config.yaml")))
    results = infer.infer(cfg, device=CPU)
    assert len(results) == 1 and results[0][1] > 0
