"""The port's batch reductions under a process group: 2 gloo ranks, each on
half of a global batch, against one process on the whole batch. For the
four criterions (U2's hybrid loss, RNN-T, the Paraformer's and wav2vec 2.0's
with their random draws handed in as rows of one global draw) the sum of the
ranks' losses is the whole batch's loss, the sum of their gradients its
gradient and the sums of their aux its aux, in train and eval mode, and the
BatchNorm running statistics come out the same on both ranks and as the
whole batch's; ``TrainBatchNorm`` alone gives the whole batch's output,
statistics and dx, and dgamma/dbeta that sum to the whole's. A rank that
holds only dummy rows contributes 0. No JAX: the reference here is the
port's own one-process step, which tests/test_torch_*.py hold to JAX."""

import sys

import pytest
import torch

import torch_dp_worker as w

LOSS_TOL = 1e-5  # relative, the sum of two fp32 shares against the whole
GRAD_TOL = 1e-4  # of each leaf's own max (the zero-gradient leaves: of the largest)
# leaves whose gradient is 0 in exact arithmetic (a bias in front of
# train-mode BatchNorm, the attention key biases): held to the largest
ZERO_LEAVES = (".conv.depthwise_conv.bias", ".linear_k.bias")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_reductions")
    addr = w.free_address()
    runs = w.launch([[sys.executable, w.WORKER, "reductions", addr, "2", str(r),
                      str(out / f"rank{r}.pt")] for r in (0, 1)], timeout=180)
    for r, (code, text) in enumerate(runs):
        assert code == 0, f"rank {r} failed:\n{text[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


@pytest.fixture(scope="module")
def whole():
    return {name: w.run_case(name) for name in w.CASES}


def _close(got, ref, what, rtol=LOSS_TOL):
    torch.testing.assert_close(got.double(), ref.double(), rtol=rtol, atol=1e-6,
                               msg=lambda m: f"{what}: {m}")


def test_batch_norm_two_ranks_equal_one(ranks, whole):
    a, b, ref = ranks[0]["batch_norm"], ranks[1]["batch_norm"], whole["batch_norm"]
    _close(torch.cat([a["y"], b["y"]]), ref["y"], "y")
    _close(torch.cat([a["dx"], b["dx"]]), ref["dx"], "dx")
    for key in ("mean", "var"):
        assert torch.equal(a[key], b[key]), key
        _close(a[key], ref[key], key)
    for key in ("dgamma", "dbeta"):  # local sums: the gradient all-reduce adds them
        _close(a[key] + b[key], ref[key], key)
        assert not torch.allclose(a[key], ref[key]), key


def test_attention_dropout_keeps_the_one_process_masks(ranks, whole):
    """The layer's generator draws the same seed on both ranks; moved to the
    rank's first row, it gives each row the mask it has in one process."""
    a, b = ranks[0]["rel_attention_dropout"], ranks[1]["rel_attention_dropout"]
    ref = whole["rel_attention_dropout"]
    _close(torch.cat([a["y"], b["y"]]), ref["y"], "y", rtol=1e-6)
    assert not torch.allclose(a["y"], b["y"])


@pytest.mark.parametrize("row0", [1, 6, 255, 4099])
def test_dropout_seed_at_row_moves_the_hash_rows(row0):
    from liteasr_tpu_torch.ops.flash_attention import (
        dropout_keep_global, dropout_seed_at_row)

    seed = -123456789
    whole = dropout_keep_global(row0 + 6, 40, 40, seed, 0.3)
    moved = dropout_seed_at_row(seed, row0)
    assert -2 ** 31 <= moved < 2 ** 31 and dropout_seed_at_row(seed, 0) == seed
    assert torch.equal(dropout_keep_global(6, 40, 40, moved, 0.3), whole[row0:])


def test_rank_seeds():
    from liteasr_tpu_torch.parallel import rank_seed

    assert rank_seed(42) == rank_seed(42, 0) == 42  # no group: rank 0
    seeds = [rank_seed(42, r) for r in range(8)]
    assert len(set(seeds)) == 8 and all(0 <= s < 2 ** 32 for s in seeds)


@pytest.mark.parametrize("case", [c for c in w.CASES
                                  if c not in ("batch_norm", "rel_attention_dropout")])
def test_criterion_two_ranks_equal_one(ranks, whole, case):
    a, b, ref = ranks[0][case], ranks[1][case], whole[case]
    _close(a["loss"] + b["loss"], ref["loss"], "loss")
    _close(a["eval_loss"] + b["eval_loss"], ref["eval_loss"], "eval loss")
    for mode in ("aux", "eval_aux"):
        assert set(a[mode]) == set(ref[mode])
        for key in ref[mode]:
            _close(a[mode][key] + b[mode][key], ref[mode][key], f"{mode} {key}")
    assert set(a["grads"]) == set(b["grads"]) == set(ref["grads"])
    top = max(g.abs().max().item() for g in ref["grads"].values())
    for name, g in ref["grads"].items():
        diff = (a["grads"][name] + b["grads"][name] - g).abs().max().item()
        scale = top if name.endswith(ZERO_LEAVES) else g.abs().max().item()
        assert diff <= GRAD_TOL * scale + 1e-9, (name, diff, scale)
    for name, buf in ref["buffers"].items():  # BatchNorm's running statistics
        assert torch.equal(a["buffers"][name], b["buffers"][name]), name
        _close(a["buffers"][name], buf, name, rtol=1e-6)


def test_a_rank_of_dummy_rows_contributes_zero(ranks, whole):
    dummy = ranks[1]["hybrid_ctc_dummy_rank"]
    assert dummy["loss"].item() == 0.0 and dummy["eval_loss"].item() == 0.0
    assert all(v.item() == 0.0 for v in dummy["eval_aux"].values())
    # its rows still enter BatchNorm's statistics, so it has gradients
    assert any(g.abs().max() > 0 for g in dummy["grads"].values())


def test_wav2vec_code_usage_is_counted_once(ranks, whole):
    """Both ranks see the global code usage: the same perplexity, each
    reporting half of it, and half of the diversity term in its loss."""
    a, b, ref = (r["wav2vec"]["eval_aux"]["code_ppl"] for r in (*ranks, whole))
    assert torch.equal(a, b)
    _close(2 * a, ref, "code_ppl")


def test_collectives_are_counted(ranks):
    for r in ranks:
        counts = r["counts"]
        assert counts["batch_norm"] > 0 and counts["count"] > 0, counts
        assert counts["code_usage"] > 0 and "grad" not in counts, counts
