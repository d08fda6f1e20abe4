"""The recipe layer of the port (liteasr_tpu_torch/tools) against the repo's
tools/: the corpus and wave generators give the same bytes at a fixed seed,
the scorer prints and writes the same numbers, run_hard composes
tools/run_hard.sh's overrides, and the tiny hard-corpus recipe runs end to
end on the CPU (train, eval, CI rows, summary) and decodes at the JAX
scripts' pad_time_multiple=512, which moves the encoder in both packages."""

import functools
import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.tools import eval_hard, run_hard, score_ci, summarize_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# the tiny U2 of the end-to-end run: 2 + 1 layers, 64-d
TINY = ["model.enc_layers=2", "model.dec_layers=1", "model.enc_dim=64",
        "model.dec_dim=64", "model.enc_ff_dim=128", "model.dec_ff_dim=128",
        "dataset.batch_size=4"]


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240, **kw)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _read(path, root=None):
    with open(path, "rb") as f:
        data = f.read()
    return data.replace(os.fsencode(root), b"<root>") if root else data


@pytest.mark.parametrize("hard", [False, True], ids=["default", "hard"])
def test_corpus_generator_is_byte_equal(tmp_path, hard):
    flags = ["--train-utts", "8", "--valid-utts", "2", "--test-utts", "2", "--seed", "3"]
    flags += ["--hard"] if hard else []
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    _run([sys.executable, "tools/make_synth_corpus.py", "--out", jax_root, *flags])
    _run([sys.executable, "-m", "liteasr_tpu_torch.tools.make_synth_corpus",
          "--out", port_root, *flags])
    assert _read(f"{jax_root}/vocab.txt") == _read(f"{port_root}/vocab.txt")
    for split in ("train", "valid", "test"):
        for name in ("feats.ark", "text", "utt2num_frames"):
            assert _read(f"{jax_root}/{split}/{name}") == _read(f"{port_root}/{split}/{name}"), \
                (split, name)
        assert (_read(f"{jax_root}/{split}/feats.scp", jax_root)
                == _read(f"{port_root}/{split}/feats.scp", port_root)), split


def test_wave_generator_is_byte_equal(tmp_path):
    flags = ["--train-utts", "3", "--valid-utts", "2", "--seed", "3"]
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    _run([sys.executable, "tools/make_synth_waves.py", "--out", jax_root, *flags])
    _run([sys.executable, "-m", "liteasr_tpu_torch.tools.make_synth_waves",
          "--out", port_root, *flags])
    for split, n in (("train", 3), ("valid", 2)):
        assert (_read(f"{jax_root}/{split}/wav.scp", jax_root)
                == _read(f"{port_root}/{split}/wav.scp", port_root)), split
        for i in range(n):
            assert _read(f"{jax_root}/{split}/u{i:05d}.wav") == \
                _read(f"{port_root}/{split}/u{i:05d}.wav"), (split, i)


def _write_dumps(root):
    """Two decodes of 40 utterances over BPE-like units and bare spaces:
    the references, and each hypothesis the reference with random edits."""
    rng = np.random.default_rng(5)
    units = ["ab", "c", "de", "f", "gh", "i", "jk", " "]
    dumps = {name: [] for name in ("a", "b")}
    for i in range(40):
        ref = [units[j] for j in rng.integers(0, len(units), rng.integers(3, 15))]
        for name, p in (("a", 0.1), ("b", 0.25)):
            hyp = []
            for tok in ref:
                r = rng.random()
                if r < p / 3:
                    continue  # deletion
                hyp.append(units[rng.integers(len(units))] if r < 2 * p / 3 else tok)
                if r > 1 - p / 3:
                    hyp.append(units[rng.integers(len(units))])  # insertion
            dumps[name].append(f"{i}\t{' '.join(ref)}\t{' '.join(hyp)}")
    paths = {}
    for name, lines in dumps.items():
        paths[name] = str(root / f"{name}.tsv")
        with open(paths[name], "w") as f:
            f.write("\n".join(lines) + "\n")
    return paths


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_score_ci_equals_the_jax_tool(tmp_path, paired):
    paths = _write_dumps(tmp_path)
    args = [paths["a"]] + (["--vs", paths["b"]] if paired else [])
    jax_rows, port_rows = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jax_out = _run([sys.executable, "tools/score_ci.py", *args, "--json-out", jax_rows])
    port_out = _run([sys.executable, "-m", "liteasr_tpu_torch.tools.score_ci", *args,
                     "--json-out", port_rows])
    assert jax_out.stdout == port_out.stdout
    assert port_out.stdout.count("95% CI") == (3 if paired else 1)
    rows = []
    for path in (jax_rows, port_rows):
        with open(path) as f:
            (row,) = [json.loads(line) for line in f]
        del row["ts"]
        rows.append(row)
    assert rows[0] == rows[1]
    assert ("p_two_sided" in rows[1]) == paired
    # the in-process call returns the row it writes
    returned = score_ci.score(*([paths["a"], paths["b"]] if paired else [paths["a"]]))
    assert returned == rows[1]


@pytest.mark.parametrize("family", ["u2", "transducer", "paraformer", "conformer"])
def test_run_hard_overrides_equal_the_shell_recipe(tmp_path, family):
    """tools/run_hard.sh:19-42 run with a ``python`` on PATH that records its
    argv: the port's overrides for the same run dir, epochs and extra
    overrides are the JAX CLI's argv after ``-m liteasr_tpu.train``; an
    unknown family exits 1 there and raises here."""
    bin_dir, run_dir, argv_out = tmp_path / "bin", tmp_path / "run", tmp_path / "argv"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text('#!/bin/sh\nprintf "%s\\0" "$@" > "$ARGV_OUT"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    extra = ["common.resume=auto", "model.enc_layers=2"]
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", ARGV_OUT=str(argv_out))
    proc = subprocess.run(["bash", "tools/run_hard.sh", family, str(run_dir), "7", *extra],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    if family not in run_hard.FAMILIES:
        assert proc.returncode == 1 and "unknown family" in proc.stdout
        with pytest.raises(ValueError, match="unknown family"):
            run_hard.overrides(family, str(run_dir), 7, extra)
        return
    assert proc.returncode == 0, proc.stderr
    argv = argv_out.read_bytes().decode().split("\0")[:-1]
    assert argv[:2] == ["-m", "liteasr_tpu.train"]
    corpus = os.path.join(REPO, "exp", "synth_hard")
    assert run_hard.overrides(family, str(run_dir), 7, extra, corpus=corpus) == argv[2:]
    assert run_hard.CORPUS == corpus


@pytest.fixture(scope="module")
def tiny_hard_run(tmp_path_factory):
    """A 16/4/4-utterance --hard corpus, run_hard u2 (tiny widths) for 2
    epochs on the CPU with a results file."""
    root = tmp_path_factory.mktemp("hard")
    corpus, run = str(root / "synth_hard"), str(root / "hard_u2_run")
    results = os.path.join(run, "results.jsonl")
    trainer = run_hard.run("u2", run, 2, TINY + [f"common.results_file={results}"],
                           corpus=corpus, corpus_utts=(16, 4, 4), device=CPU)
    return trainer, corpus, run, results


def test_tiny_recipe_end_to_end(tiny_hard_run, capsys):
    trainer, corpus, run, results = tiny_hard_run
    with open(os.path.join(corpus, "vocab.txt")) as f:
        assert trainer.task.vocab_size == len(f.readlines()) + 2  # blank, sos/eos
    assert trainer.epoch == 2 and trainer.cfg.model.dtype == "bfloat16"
    assert sorted(os.listdir(os.path.join(run, "ckpts")))[:2] == ["model.ep.1.pt",
                                                                   "model.ep.2.pt"]
    eval_hard.main(["u2", run, "2", "2", "--device", "cpu"])
    out = os.path.join(run, "eval_ep2")
    for name in ("avg_rescore", "avg_ctc_greedy", "last_rescore"):
        with open(os.path.join(out, f"{name}.tsv")) as f:
            lines = [line.rstrip("\n").split("\t") for line in f]
        assert [p[0] for p in lines] == [str(i) for i in range(4)], name
        assert all(len(p) == 3 and p[1] for p in lines), name
    with open(results) as f:
        rows = [json.loads(line) for line in f]
    ci = [r for r in rows if r["kind"] == "score_ci"]
    assert [r.get("vs") for r in ci] == [None, f"{out}/avg_ctc_greedy.tsv",
                                         f"{out}/last_rescore.tsv"]
    assert all(r["n_utts"] == 4 and r["ci95"][0] <= r["rate"] <= r["ci95"][1] for r in ci)
    valid = [r for r in rows if r["kind"] == "valid"]
    logged, _, _ = summarize_run.main([os.path.join(run, "train.log"), "--every", "1"])
    assert [(ep, it) for ep, it, _ in logged] == [(r["epoch"], r["iter"]) for r in valid]
    assert [v for _, _, v in logged] == [round(r["valid_loss"], 2) for r in valid]
    assert "| 2 | " in capsys.readouterr().out


def test_run_hard_timeout_stops_at_an_epoch_boundary(tiny_hard_run, tmp_path):
    """``timeout_s`` starts no epoch after it: the run ends at the first
    epoch boundary past it with that epoch's valid row and save whole, and a
    resume carries on from there."""
    _, corpus, _, _ = tiny_hard_run
    run = str(tmp_path / "run")
    results = os.path.join(run, "results.jsonl")
    extra = TINY + ["common.resume=auto", f"common.results_file={results}"]
    trainer = run_hard.run("u2", run, 3, extra, corpus=corpus, timeout_s=1e-9, device=CPU)
    ckpts = os.path.join(run, "ckpts")
    assert trainer.epoch == 1 and sorted(os.listdir(ckpts)) == [
        "model.ep.1.pt", "train_state.pt", "train_state.pt.meta"]
    with open(os.path.join(ckpts, "train_state.pt.meta")) as f:
        assert json.load(f) == {"iter": trainer.iter, "epoch": 1}
    trainer = run_hard.run("u2", run, 2, extra, corpus=corpus, device=CPU)
    assert trainer.epoch == 2
    with open(results) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows if r["kind"] == "valid"] == [1, 2]


@functools.lru_cache(maxsize=None)
def _jax_u2():
    """test_torch_u2.build_pair's JAX model, its init and encode jitted
    once for the cases below."""
    import jax

    from liteasr_tpu.models.u2 import U2 as JaxU2
    from test_torch_u2 import TINY as U2_TINY

    jmodel = JaxU2(**U2_TINY)
    return (jmodel, jax.jit(jmodel.init),
            jax.jit(lambda v, x, n: jmodel.apply(v, x, n, method=jmodel.encode)))


@pytest.mark.parametrize("seed", [0, 1])
def test_padded_length_moves_the_encoder_as_in_jax(seed):
    """tools/eval_hard.sh:20-24's dataset.pad_time_multiple=512 is not inert:
    the rel-pos table has the batch's padded length T' and the legacy
    rel_shift indexes it from its end (liteasr_tpu/nets/encoder.py:115-127),
    so the padding moves the valid frames' encoder output. The port equals
    JAX's encoder at each padded length, and the two lengths differ in both,
    which is why eval_hard keeps the JAX scripts' 512."""
    import jax
    import jax.numpy as jnp

    from liteasr_tpu_torch.bridge import flax_to_state_dict
    from liteasr_tpu_torch.models.u2 import U2 as TorchU2
    from test_torch_u2 import TINY as U2_TINY, perturb, ragged_batch, t

    _, init, encode = _jax_u2()  # test_torch_u2.build_pair's pair
    variables = perturb(jax.device_get(init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 64, U2_TINY["input_dim"])),
        jnp.full((2,), 64), jnp.ones((2, 4), jnp.int32), jnp.full((2,), 4))), seed)
    tmodel = TorchU2(**U2_TINY)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    tmodel.eval()
    xs, xlens, _, _ = ragged_batch(seed)
    valid, outs, n = None, {}, 31  # n: T' of the 128-frame padding
    for T in (128, 512):
        padded = np.zeros((xs.shape[0], T, xs.shape[2]), np.float32)
        padded[:, :xs.shape[1]] = xs
        j_enc, j_mask = encode(variables, padded, xlens)
        with torch.no_grad():
            h_enc, mask = tmodel.encode(t(padded), t(xlens))
        keep = ~mask.numpy().reshape(xs.shape[0], -1)
        valid = keep[:, :n] if valid is None else valid
        np.testing.assert_array_equal(keep, ~np.asarray(j_mask).reshape(keep.shape))
        np.testing.assert_allclose(h_enc.numpy(), np.asarray(j_enc), rtol=2e-4, atol=2e-4)
        outs[T] = (h_enc.numpy()[:, :n][valid], np.asarray(j_enc)[:, :n][valid])
    for port_or_jax in (0, 1):
        assert np.abs(outs[128][port_or_jax] - outs[512][port_or_jax]).max() > 1e-2


def test_eval_hard_decodes_at_the_jax_padding(tiny_hard_run, tmp_path):
    """eval_hard's last-checkpoint rescore equals one infer decode of the
    same checkpoint at pad_time_multiple=512, token for token."""
    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    _, _, run, results = tiny_hard_run
    report = eval_hard.evaluate("u2", run, 2, 1, device=CPU, results=str(tmp_path / "ci.jsonl"))
    assert set(report["decodes"]) == {"avg_rescore", "avg_ctc_greedy", "last_rescore"}
    dump = str(tmp_path / "pad512.tsv")
    cfg = compose(["inference.ckpt_name=2", "inference.model_avg=false",
                   "inference.batch_size=32", f"inference.dump={dump}",
                   f"dataset.pad_time_multiple={eval_hard.PAD_TIME_MULTIPLE}"],
                  base=load_yaml(os.path.join(run, "config.yaml")))
    infer.infer(cfg, device=CPU)
    with open(dump) as f, open(os.path.join(run, "eval_ep2", "last_rescore.tsv")) as g:
        assert f.read() == g.read()
    with open(tmp_path / "ci.jsonl") as f:
        assert len(f.readlines()) == 3
