"""wav2vec 2.0 pretraining through the CLIs on the CPU at tiny widths: a
checkpoint that the JAX training CLI wrote, loaded by the port, scores a
valid batch at JAX's draws as JAX does; the port's own train CLI
(``task=pretrain model=wav2vec2 criterion=wav2vec``) writes the
``valid loss: ... | accuracy: ... | code_ppl: ...`` lines and rows that
the JAX trainer writes, and a resumed run equals the uninterrupted one."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wav2vec2 import TINY, hand_draws, jax_forward

CPU = torch.device("cpu")
SMALL = [f"model.{k}={v}" for k, v in TINY.items() if not k.startswith(("dropout",
                                                                       "attention"))]
VALID_RE = re.compile(r"valid loss: (\S+)((?: \| \w+: \S+)*)$")


@pytest.fixture(autouse=True, scope="module")
def _restore_prng_impl():
    """The JAX Trainer sets the process-global PRNG implementation and never
    restores it (liteasr_tpu/trainer.py:172-174); put it back after."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    """6 train and 2 valid waves of 1800-2600 samples (tests/test_wav2vec2.py's)."""
    from liteasr_tpu_torch.data import kaldi_io

    root = tmp_path_factory.mktemp("w2v_wavs")
    rng = np.random.default_rng(7)
    for split, n in (("train", 6), ("valid", 2)):
        d = root / split
        d.mkdir()
        lines = []
        for i in range(n):
            p = str(d / f"u{i}.wav")
            kaldi_io.write_wav(p, (rng.normal(size=int(rng.integers(1800, 2600)))
                                   * 0.05).astype(np.float32))
            lines.append(f"{split}u{i} {p}")
        (d / "wav.scp").write_text("\n".join(lines) + "\n")
    return root


def _overrides(corpus, out, epochs=2):
    return ["task=pretrain", "model=wav2vec2", "criterion=wav2vec", "optimizer=my_adam",
            "optimizer.lr=1e-3", "criterion.diversity_weight=1.0",
            f"task.train={corpus / 'train'}", f"task.valid={corpus / 'valid'}",
            f"task.save_dir={out / 'ckpts'}", f"common.run_dir={out}",
            f"common.results_file={out / 'results.jsonl'}",
            f"optimization.max_epoch={epochs}", "optimization.accum_grad=1",
            "optimization.clip_grad_norm=5.0", "dataset.num_workers=1", *SMALL]


def valid_lines(run):
    """[(loss, {key: value})] of each ``valid loss:`` line of train.log."""
    out = []
    for line in (run / "train.log").read_text().splitlines():
        m = VALID_RE.search(line)
        if m:
            out.append((m.group(1), dict(re.findall(r" \| (\w+): (\S+)", m.group(2)))))
    return out


@pytest.fixture(scope="module")
def jax_run(wav_corpus, tmp_path_factory):
    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu.train import setup_logging, train

    out = tmp_path_factory.mktemp("jax_w2v")
    setup_logging(str(out))
    train(jax_compose(_overrides(wav_corpus, out, epochs=1)))
    return out


def test_jax_checkpoint_scores_as_jax(jax_run, wav_corpus):
    """model.ep.1.msgpack from the JAX CLI, read by the port's checkpoint
    reader: the valid batch's eval loss, accuracy and code_ppl at JAX's
    draws equal JAX's; the JAX run's valid line has the keys the port's
    trainer writes."""
    from liteasr_tpu import checkpoint as jckpt
    from liteasr_tpu.config.core import DotDict as JaxDotDict
    from liteasr_tpu.criterions.wav2vec_loss import Wav2Vec2Loss as JaxLoss
    from liteasr_tpu.models.wav2vec2 import Wav2Vec2 as JaxW2V
    from liteasr_tpu_torch.checkpoint import load_params
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss
    from liteasr_tpu_torch.data.dataset import RawAudioFileDataset
    from liteasr_tpu_torch.models.wav2vec2 import Wav2Vec2
    from liteasr_tpu_torch.trainer import to_device

    path = str(jax_run / "ckpts" / "model.ep.1.msgpack")
    ds = RawAudioFileDataset(str(wav_corpus / "valid"), DotDict(crop_multiple=8000,
                                                               pad_batch_multiple=4))
    b = ds.collator(ds[0])
    assert b["valid"].tolist() == [1, 1, 0, 0]
    cfg = dict(TINY, dropout=0.1, attention_dropout=0.1)
    jmodel, variables = JaxW2V(**cfg), jckpt.load_params(path)
    jcrit = JaxLoss(JaxDotDict(diversity_weight=1.0))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, jaux = jax.device_get(jax.jit(
        lambda v, b: jcrit(jmodel, v, b, train=False))(variables, jb))
    _, mask, _, u, _, _ = jax_forward(jmodel, variables, b, False)

    tmodel = Wav2Vec2(**cfg)
    tmodel.load_state_dict(load_params(path), strict=True)
    hand_draws(tmodel, mask, u)
    with torch.no_grad():
        loss, aux = Wav2Vec2Loss(DotDict(diversity_weight=1.0))(
            tmodel, to_device(b, CPU), train=False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("accuracy", "code_ppl"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    (line,) = valid_lines(jax_run)
    assert sorted(line[1]) == ["accuracy", "code_ppl"]


@pytest.fixture(scope="module")
def port_run(wav_corpus, tmp_path_factory):
    from liteasr_tpu_torch import train

    out = tmp_path_factory.mktemp("port_w2v")
    trainer = train.main(_overrides(wav_corpus, out), device=CPU)
    return out, trainer


def test_train_cli_writes_valid_metrics(port_run):
    """2 epochs on the CPU: finite losses, every parameter moved (the
    codebook and mask_emb among them), model.ep.2.pt, and per epoch a
    ``valid loss: x | accuracy: y | code_ppl: z`` line and a results row
    with those keys (6 decimals)."""
    from liteasr_tpu_torch.models.wav2vec2 import Wav2Vec2

    out, trainer = port_run
    assert type(trainer.model).__name__ == "Wav2Vec2"
    micro = 2 * len(trainer.task.dataset("train"))  # one batch per epoch: 6 short waves
    assert trainer.epoch == 2 and trainer.step == micro and int(trainer.tx.count) == micro
    assert bool(torch.isfinite(torch.stack(trainer._loss_accum)).all())
    lines = valid_lines(out)
    assert len(lines) == 2 and all(sorted(k) == ["accuracy", "code_ppl"] for _, k in lines)
    assert all(re.fullmatch(r"-?\d+\.\d{4}", v) for _, k in lines for v in k.values())
    rows = [json.loads(r) for r in (out / "results.jsonl").read_text().splitlines()]
    valid_rows = [r for r in rows if r["kind"] == "valid"]
    assert [r["epoch"] for r in valid_rows] == [1, 2]
    for r, (_, k) in zip(valid_rows, lines):
        assert {"accuracy", "code_ppl"} <= set(r)
        assert all(abs(r[n] - float(v)) <= 5e-5 for n, v in k.items())
    init = Wav2Vec2(**dict(TINY, dropout=0.1, attention_dropout=0.1),
                    generator=torch.Generator().manual_seed(42))
    moved = {n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach(), dict(init.named_parameters())[n])}
    assert moved == set(dict(init.named_parameters()))
    assert (out / "ckpts" / "model.ep.2.pt").is_file()


def test_resume_equals_the_uninterrupted_run(port_run, wav_corpus, tmp_path):
    """1 epoch, then ``common.resume=auto`` to 2: the same valid lines and
    bit-identical parameters as the 2-epoch run; the resume state holds the
    mask, negatives and Gumbel generators."""
    from liteasr_tpu_torch import train
    from liteasr_tpu_torch.trainer import TRAIN_STATE

    out, trainer = port_run
    train.main(_overrides(wav_corpus, tmp_path, epochs=1), device=CPU)
    state = torch.load(tmp_path / "ckpts" / TRAIN_STATE, weights_only=True)
    assert {"mask", "negatives", "gumbel"} <= set(state["rng"])
    resumed = train.main(_overrides(wav_corpus, tmp_path) + ["common.resume=auto"],
                         device=CPU)
    assert resumed.epoch == 2 and resumed.step == trainer.step
    assert valid_lines(tmp_path) == valid_lines(out)
    for (n, p), q in zip(trainer.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n
