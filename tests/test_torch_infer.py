"""liteasr_tpu_torch.infer against liteasr_tpu.infer on the tiny Kaldi corpus
with the same bridged parameters: the same hypothesis texts and the same
error count; and the CLI path (compose -> checkpoint -> infer) on the CPU."""

import pytest
import torch

from liteasr_tpu.config.core import DotDict
from liteasr_tpu.infer import infer_dataset as jax_infer_dataset
from liteasr_tpu.tasks.asr import ASRTask as JaxASRTask
from liteasr_tpu_torch import checkpoint, infer
from liteasr_tpu_torch.config import compose
from liteasr_tpu_torch.bridge import flax_to_state_dict
from liteasr_tpu_torch.tasks.asr import ASRTask

from test_torch_u2 import build_pair


def _task_cfg(corpus, save_dir):
    return dict(name="asr", vocab=str(corpus / "vocab.txt"),
                train=str(corpus / "train"), valid=str(corpus / "valid"),
                test=[str(corpus / "test")], delimiter=None,
                save_dir=str(save_dir))


@pytest.fixture(scope="module")
def decoded(tiny_corpus, tmp_path_factory):
    save = tmp_path_factory.mktemp("ckpt")
    jtask = JaxASRTask(DotDict(_task_cfg(tiny_corpus, save)))
    jtask.load_dataset("test", str(tiny_corpus / "test"))
    ttask = ASRTask(DotDict(_task_cfg(tiny_corpus, save)))
    ttask.load_dataset("test", str(tiny_corpus / "test"))
    jmodel, variables, tmodel = build_pair(
        8, vocab_size=jtask.vocab_size, input_dim=16)
    infer_cfg = DotDict(batch_size=3, beam_size=4, ctc_weight=0.5,
                        mode="attention_rescore")
    j_pairs, t_pairs = [], []
    j_res = jax_infer_dataset(jtask, jmodel, variables,
                              jtask.dataset("test"), infer_cfg,
                              verbose=False, collect=j_pairs)
    t_res = infer.infer_dataset(ttask, tmodel, ttask.dataset("test"),
                                infer_cfg, torch.device("cpu"),
                                verbose=False, collect=t_pairs)
    return dict(save=save, variables=variables, jres=j_res, tres=t_res,
                jpairs=j_pairs, tpairs=t_pairs, vocab_size=jtask.vocab_size)


def test_infer_dataset_matches_jax(decoded):
    assert decoded["tpairs"] == decoded["jpairs"]
    assert decoded["tres"] == decoded["jres"]


def test_infer_cli_from_checkpoint(decoded, tiny_corpus, tmp_path):
    """compose (model=my_U2 preset) -> model.ep.N.pt -> infer, on the CPU."""
    save = decoded["save"]
    torch.save(flax_to_state_dict(decoded["variables"]),
               str(save / checkpoint.CKPT_TEMPLATE.format(3)))
    overrides = [
        "task=asr", "model=my_U2", f"task.vocab={tiny_corpus / 'vocab.txt'}",
        f"task.save_dir={save}", f"task.test=[{tiny_corpus / 'test'}]",
        f"common.run_dir={tmp_path}", "inference.ckpt_name=3",
        "inference.model_avg=false", "inference.batch_size=3",
        "inference.beam_size=4", "model.enc_layers=2", "model.dec_layers=1",
        "model.enc_dim=32", "model.enc_ff_dim=64", "model.dec_dim=32",
        "model.dec_ff_dim=64"]
    results = infer.infer(compose(overrides), device=torch.device("cpu"))
    assert results == [decoded["tres"]]


def test_model_averaging_raises(tmp_path):
    """Averaging more checkpoints than exist up to ckpt_name raises
    (tests/test_torch_checkpoint.py holds the averages to the JAX package)."""
    torch.save({"w": torch.ones(2)}, tmp_path / "model.ep.1.pt")
    with pytest.raises(ValueError, match="avg_num=2"):
        checkpoint.load_ckpt(DotDict(ckpt_path=str(tmp_path), ckpt_name=1,
                                     model_avg=True, avg_num=2, avg_policy=None))
