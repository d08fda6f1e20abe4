"""liteasr_tpu_torch's checkpoint loading against liteasr_tpu's, on the CPU:
which checkpoints ``load_ckpt`` averages (last N; N best by the
``valid loss:`` lines of train.log, keyed by epoch, with nan last, a coarser
save interval, a resumed run's repeated epochs, an epoch-less log, a run
dir as the policy), the average itself (float and integer leaves, exact),
the spread warning, and the msgpack reader against flax on files flax
wrote, including a U2 checkpoint of the JAX package loaded into the port's
model."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from liteasr_tpu import checkpoint as jckpt
from liteasr_tpu.config.core import DotDict as JaxDotDict
from liteasr_tpu_torch import checkpoint as tckpt
from liteasr_tpu_torch.bridge import flax_to_state_dict
from liteasr_tpu_torch.config.core import DotDict

from test_torch_u2 import build_pair


def _valid_line(ep, loss, max_ep=12):
    return (f"[ts][INFO][liteasr_tpu_torch.trainer:190][valid] - {ep * 10} / inf "
            f"iters, {ep} / {max_ep} epochs - valid loss: {loss}\n")


def _write_ckpts(root, epochs):
    """Both packages' checkpoints of the same values: w = epoch (float),
    n = 3 * epoch (int32). Returns the JAX and the port's directory."""
    jdir, tdir = root / "jax", root / "torch"
    jdir.mkdir()
    tdir.mkdir()
    for ep in epochs:
        w = np.full((3,), float(ep), np.float32)
        n = np.full((2,), 3 * ep, np.int32)
        jckpt.save_params(str(jdir / f"model.ep.{ep}.msgpack"), {"params": {"w": w, "n": n}})
        torch.save({"w": torch.from_numpy(w), "n": torch.from_numpy(n)},
                   tdir / f"model.ep.{ep}.pt")
    # train-state files share the directory and are never averaged
    (tdir / "train_state.pt").write_bytes(b"xx")
    (tdir / "train_state.pt.meta").write_text("{}")
    return jdir, tdir


_LOGS = {
    "every_epoch": (range(1, 7), lambda: "".join(
        _valid_line(ep, v) for ep, v in enumerate([5.0, 3.0, 4.0, 1.5, 2.0, 2.5], 1))),
    "nan": (range(1, 7), lambda: "".join(
        _valid_line(ep, v) for ep, v in enumerate([5.0, "nan", 4.0, "nan", 2.0, 2.5], 1))),
    "coarse_saves": ((4, 8, 12), lambda: "".join(
        _valid_line(ep, 13.0 - ep) for ep in range(1, 13))),
    "resumed_repeats": (range(1, 5), lambda: "".join(
        _valid_line(ep, v) for ep, v in [(1, 4.0), (2, 3.0), (3, 9.0), (3, 0.5),
                                         (4, 2.0)])),
    "no_epochs": (range(1, 6), lambda: "".join(
        f"... valid loss: {v}\n" for v in [3.0, 1.0, 2.0, 0.5])),
    "scientific": (range(1, 5), lambda: "".join(
        _valid_line(ep, v) for ep, v in enumerate(["1.5e-02", "-3.0", "2.5E+00", "inf"], 1))),
}


@pytest.mark.parametrize("case", sorted(_LOGS))
@pytest.mark.parametrize("avg_num", [1, 2, 3])
@pytest.mark.parametrize("policy", ["log", "run_dir", "none"])
def test_averaged_checkpoints_match_jax(tmp_path, case, avg_num, policy):
    epochs, log = _LOGS[case]
    jdir, tdir = _write_ckpts(tmp_path, epochs)
    run = tmp_path / "run"
    run.mkdir()
    (run / "train.log").write_text(log())
    avg_policy = {"log": str(run / "train.log"), "run_dir": str(run), "none": None}[policy]
    common = dict(ckpt_name=max(epochs), model_avg=True, avg_num=avg_num,
                  avg_policy=avg_policy)
    ref = jckpt.load_ckpt(JaxDotDict(ckpt_path=str(jdir), **common))["params"]
    got = tckpt.load_ckpt(DotDict(ckpt_path=str(tdir), **common))
    assert set(got) == {"w", "n"} and got["n"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(ref["w"]))
    np.testing.assert_array_equal(got["n"].numpy(), np.asarray(ref["n"]))


def test_average_of_random_leaves_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths_j, paths_t = [], []
    for ep in range(1, 5):
        tree = {"params": {"a": {"kernel": rng.normal(size=(5, 7)).astype(np.float32)},
                           "n": rng.integers(-50, 50, size=(4,)).astype(np.int32)}}
        pj, pt = tmp_path / f"model.ep.{ep}.msgpack", tmp_path / f"model.ep.{ep}.pt"
        jckpt.save_params(str(pj), tree)
        torch.save({"a.kernel": torch.from_numpy(tree["params"]["a"]["kernel"]),
                    "n": torch.from_numpy(tree["params"]["n"])}, pt)
        paths_j.append(str(pj))
        paths_t.append(str(pt))
    ref = jckpt._average_params(paths_j)["params"]
    got = tckpt._average_params(paths_t)
    np.testing.assert_array_equal(got["a.kernel"].numpy(), np.asarray(ref["a"]["kernel"]))
    np.testing.assert_array_equal(got["n"].numpy(), np.asarray(ref["n"]))


def test_spread_warning_and_errors_match_jax(tmp_path, caplog):
    for losses in ([1.0, 1.02, 0.99], [1.0, 2.5, 1.1], [float("nan"), 1.0], [3.0]):
        assert tckpt.check_avg_spread(losses) == jckpt.check_avg_spread(losses)
    _, tdir = _write_ckpts(tmp_path, (1, 2, 3))
    (tmp_path / "train.log").write_text("".join(
        _valid_line(ep, v) for ep, v in [(1, 0.5), (2, 2.0), (3, 0.6)]))
    cfg = dict(ckpt_path=str(tdir), ckpt_name=3, model_avg=True,
               avg_policy=str(tmp_path / "train.log"))
    caplog.clear()  # the unit-level trip above logged once
    with caplog.at_level(logging.WARNING, logger="liteasr_tpu_torch.checkpoint"):
        tckpt.load_ckpt(DotDict(cfg, avg_num=2))
        assert not any("oscillating" in r.message for r in caplog.records)
        tckpt.load_ckpt(DotDict(cfg, avg_num=3))
        assert any("oscillating" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="avg_num=4"):
        tckpt.load_ckpt(DotDict(cfg, avg_num=4))
    with pytest.raises(FileNotFoundError):
        tckpt.load_ckpt(DotDict(cfg, ckpt_name=7))
    assert tckpt.parse_valid_history(str(tmp_path / "train.log")) == \
        jckpt.parse_valid_history(str(tmp_path / "train.log"))


def test_msgpack_reader_matches_flax(tmp_path):
    tree = {"params": {"a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                             "bias": np.zeros((0,), np.float32)},
                       "bf": jnp.full((2, 3), 1.5, jnp.bfloat16),
                       "f64": np.linspace(0, 1, 300), "i8": np.int8(-3)},
            "meta": {"step": 70000, "neg": -5, "lr": 1.25, "ok": True, "name": "x" * 40,
                     "none": None, "shape": [1, 2, 3]}}
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    ref = serialization.msgpack_restore(path.read_bytes())
    got = tckpt.msgpack_restore(path.read_bytes())

    def compare(r, g, where=""):
        if isinstance(r, dict):
            assert isinstance(g, dict) and set(g) == set(r), where
            for k in r:
                compare(r[k], g[k], f"{where}/{k}")
        elif isinstance(r, (str, bool, int, float, type(None), list)):
            assert g == r and type(g) is type(r), where
        else:
            r = np.asarray(r, np.float64 if np.asarray(r).dtype.name == "bfloat16" else None)
            assert np.asarray(g).shape == r.shape, where
            np.testing.assert_array_equal(np.asarray(g, r.dtype), r, err_msg=where)

    compare(ref, got)


def test_jax_u2_checkpoint_loads_into_the_port(tmp_path):
    """A ``model.ep.N.msgpack`` that the JAX package saved decodes into the
    port's model exactly; averaging two of them equals averaging the
    bridged state_dicts."""
    _, variables, tmodel = build_pair(3)
    _, variables2, _ = build_pair(4)
    jckpt.save_params(str(tmp_path / "model.ep.1.msgpack"), variables)
    jckpt.save_params(str(tmp_path / "model.ep.2.msgpack"), variables2)
    sd = tckpt.load_ckpt(DotDict(ckpt_path=str(tmp_path), ckpt_name=1, model_avg=False))
    ref = flax_to_state_dict(variables)
    assert set(sd) == set(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    tmodel.load_state_dict(sd, strict=True)
    avg = tckpt.load_ckpt(DotDict(ckpt_path=str(tmp_path), ckpt_name=2, model_avg=True,
                                  avg_num=2, avg_policy=None))
    ref2 = flax_to_state_dict(variables2)
    for k in ref:
        torch.testing.assert_close(avg[k], (ref[k] + ref2[k]) / 2, rtol=0, atol=0)
