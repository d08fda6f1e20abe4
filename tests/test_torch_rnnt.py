"""liteasr_tpu_torch's RNN-T loss (ops/rnnt.py) against liteasr_tpu's and a
brute-force lattice oracle, on the CPU in fp32: per-utterance losses with
ragged lengths and a 1-label row, gradients against ``jax.grad`` within
1e-5, and exactly zero gradient beyond each row's lengths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu.ops.rnnt import rnnt_loss as jax_rnnt_loss
from liteasr_tpu_torch.ops.rnnt import rnnt_loss
from rnnt_oracle import oracle_rnnt

TOL = 1e-5


def _case(seed: int, B: int = 4, T: int = 9, U: int = 5, V: int = 7):
    """Ragged rows: full, shorter in both, a 1-label row, a 1-frame row."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.normal(size=(B, T, U + 1, V))).astype(np.float32)
    targets = rng.integers(1, V, size=(B, U)).astype(np.int32)
    in_lens = np.array([T, T - 2, T - 4, 1][:B], np.int32)
    lab_lens = np.array([U, U - 2, 1, 1][:B], np.int32)
    return logits, targets, in_lens, lab_lens


def _jax(logits, targets, in_lens, lab_lens):
    def total(lg):
        per = jax_rnnt_loss(lg, jnp.asarray(targets), jnp.asarray(in_lens),
                            jnp.asarray(lab_lens))
        return per.sum(), per

    (_, per), grad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(logits))
    return np.asarray(per), np.asarray(grad)


def _torch(logits, targets, in_lens, lab_lens):
    lg = torch.from_numpy(logits).requires_grad_()
    per = rnnt_loss(lg, torch.from_numpy(targets), torch.from_numpy(in_lens),
                    torch.from_numpy(lab_lens))
    per.sum().backward()
    return per.detach().numpy(), lg.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_matches_jax_and_the_oracle(seed):
    logits, targets, in_lens, lab_lens = _case(seed)
    per, _ = _torch(logits, targets, in_lens, lab_lens)
    j_per, _ = _jax(logits, targets, in_lens, lab_lens)
    np.testing.assert_allclose(per, j_per, rtol=TOL, atol=TOL)
    logp = np.asarray(torch.log_softmax(torch.from_numpy(logits).double(), -1))
    for b in range(logits.shape[0]):
        ref = oracle_rnnt(logp[b], targets[b], int(in_lens[b]), int(lab_lens[b]))
        np.testing.assert_allclose(per[b], ref, rtol=TOL, atol=TOL, err_msg=f"row {b}")


@pytest.mark.parametrize("seed", [3, 4])
def test_gradients_match_jax(seed):
    logits, targets, in_lens, lab_lens = _case(seed)
    _, grad = _torch(logits, targets, in_lens, lab_lens)
    _, j_grad = _jax(logits, targets, in_lens, lab_lens)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, j_grad, rtol=TOL, atol=TOL)


def test_gradient_is_zero_beyond_the_lengths():
    logits, targets, in_lens, lab_lens = _case(5)
    _, grad = _torch(logits, targets, in_lens, lab_lens)
    T, U1 = logits.shape[1], logits.shape[2]
    for b in range(logits.shape[0]):
        t_out = np.arange(T) >= in_lens[b]
        u_out = np.arange(U1) > lab_lens[b]
        assert (grad[b, t_out] == 0).all(), b
        assert (grad[b][:, u_out] == 0).all(), b
        assert np.abs(grad[b, ~t_out][:, ~u_out]).sum() > 0, b


def test_bf16_logits_stay_close_to_fp32():
    """The bf16 lattice of the training step: the lse and the DP run in
    fp32 on the widened scores, so the loss moves only by bf16's rounding
    of the logits."""
    logits, targets, in_lens, lab_lens = _case(6)
    args = [torch.from_numpy(a) for a in (targets, in_lens, lab_lens)]
    ref = rnnt_loss(torch.from_numpy(logits), *args)
    lg = torch.from_numpy(logits).bfloat16().requires_grad_()
    got = rnnt_loss(lg, *args)
    got.sum().backward()
    assert got.dtype == torch.float32 and lg.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=2e-2, atol=5e-2)
    assert torch.isfinite(lg.grad.float()).all()


def test_lattice_shape_mismatch_raises():
    logits, targets, in_lens, lab_lens = _case(7)
    with pytest.raises(ValueError, match="against the lattice"):
        rnnt_loss(torch.from_numpy(logits), torch.from_numpy(targets[:, :-1]),
                  torch.from_numpy(in_lens), torch.from_numpy(lab_lens))
