"""The RNN-T loss's DP kernels (``csrc/rnnt_dp.cu``) on the card, without JAX
(``python -m pytest --noconftest -m gpu tests/test_torch_rnnt_gpu.py``).

On the card (marker ``gpu``, skipped without CUDA) the kernels' loss and
both gradients are held against an fp64 reference: the brute-force oracle
of ``rnnt_oracle.py`` for the losses of the small cases, and the plain loop
in fp64 on the CPU (which ``test_torch_rnnt.py`` holds to that oracle and
to JAX) for the gradients and the large case. A loss is held to 1e-5 of
itself. A gradient, exp(alpha + lp + beta - logZ), carries in its exponent
the rounding of fp32 numbers as large as logZ along a chain of T + U steps,
delta = 4 sqrt(T + U) ulp(logZ), and so an error of delta of itself: the
kernels' gradients are held to delta of each gradient, over a floor of
1e-6 far below any gradient that the lengths keep (a label's emit
gradients sum to its weight over T' frames, a frame's blank gradients over
U + 1 columns). Every planted fault of the backward (beta a frame or a
label late, another row's logZ, the cotangent left out, the gradients
below e^-10 flushed to 0, which a limit of delta absolute lets through)
breaks that limit at every shape, which runs without a card. The plain loop that the kernels
replace, run in fp32 on the card, is held to its own limit: its emit
gradient leaves autograd through the differences of a cumulative sum, so
its error is one of the largest gradient, delta of it. The cases: ragged
rows, a 1-frame row, a 0-label row and a row whose loss takes weight 0;
U + 1 of 1, 32, 33 and 65 and one above the kernels' block width (1024
columns); the cell's largest shape (T' = 383, U = 46, 90 rows); a bf16
lattice through ``rnnt_loss``. Beyond each row's lengths, and on the
weight-0 row, the gradient is exactly 0. Forward and backward run under
``torch.cuda.set_sync_debug_mode("error")`` with one launch each, and a
forward under ``no_grad`` launches the forward alone. CPU tensors launch
nothing (checked without a card too).
"""

import math

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.ops import rnnt
from rnnt_oracle import oracle_rnnt

LOG_V = float(np.log(4233 / 3))  # three-way log-probs shifted to a 4,233-way lattice's size
# (name, B, T, U): the first three rows are ragged, a 1-frame row and a 0-label row
SHAPES = [("u1_1", 5, 7, 0), ("u1_32", 6, 13, 31), ("u1_33", 6, 11, 32),
          ("u1_65", 5, 9, 64), ("u1_1100", 4, 6, 1099)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _planes(B, T, U, seed):
    """fp64 (lp_blank (B, T, U+1), lp_emit (B, T, U)), int64 lengths with a
    full row, a 1-frame row and a 0-label row, and per-row weights with a 0."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(2.0 * rng.normal(size=(B, T, U + 1, 3))), -1)
    lp_blank, lp_emit = lp[..., 0] - LOG_V, lp[:, :, :U, 1] - LOG_V
    in_lens = torch.from_numpy(rng.integers(1, T + 1, B))
    lab_lens = torch.from_numpy(rng.integers(0, U + 1, B))
    in_lens[0], lab_lens[0] = T, U
    in_lens[1] = 1
    lab_lens[2] = 0
    weights = torch.from_numpy(rng.uniform(0.5, 1.5, B))
    weights[-1] = 0.0
    return lp_blank.contiguous(), lp_emit.contiguous(), in_lens, lab_lens, weights


def _loss_and_grads(lp_blank, lp_emit, in_lens, lab_lens, weights, dp=None):
    """The losses and the gradients of sum(weights * losses) through ``dp``
    (``lattice_nll`` by default), as fp64 on the CPU."""
    b, e = (x.detach().clone().requires_grad_() for x in (lp_blank, lp_emit))
    loss = (dp or rnnt.lattice_nll)(b, e, in_lens, lab_lens)
    (loss * weights.to(loss)).sum().backward()
    return [x.detach().double().cpu() for x in (loss, b.grad, e.grad)]


def _grad_tol(T, U, loss):
    """(rtol, atol) of the kernels' gradients: delta of each, over a floor."""
    return 4.0 * np.sqrt(T + U) * float(np.spacing(np.float32(loss.abs().max()))), 1e-6


def _within(got, want, rtol, atol):
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _check(B, T, U, seed, dev, oracle: bool):
    lp_blank, lp_emit, in_lens, lab_lens, weights = _planes(B, T, U, seed)
    ref = _loss_and_grads(lp_blank, lp_emit, in_lens, lab_lens, weights)
    if oracle:
        logp = torch.stack([lp_blank, torch.cat([lp_emit, lp_emit.new_zeros(B, T, 1)], 2)],
                           -1).numpy()
        want = [oracle_rnnt(logp[r], np.ones(U, int), int(in_lens[r]), int(lab_lens[r]))
                for r in range(B)]
        np.testing.assert_allclose(ref[0].numpy(), want, rtol=1e-12)
    on_card = [x.float().to(dev) for x in (lp_blank, lp_emit)] + [in_lens.to(dev),
                                                                   lab_lens.to(dev), weights]
    before = (rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches)
    got = _loss_and_grads(*on_card)
    torch.cuda.synchronize()
    assert (rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    plain = _loss_and_grads(*on_card, dp=rnnt._lattice_nll)
    rtol, atol = _grad_tol(T, U, ref[0])
    for name, (k, p, r) in zip(("loss", "d lp_blank", "d lp_emit"), zip(got, plain, ref)):
        if name == "loss":
            np.testing.assert_allclose(k.numpy(), r.numpy(), rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=1e-5, err_msg=name)
            continue
        np.testing.assert_allclose(k.numpy(), r.numpy(), rtol=rtol, atol=atol, err_msg=name)
        np.testing.assert_allclose(p.numpy(), r.numpy(), atol=rtol, err_msg="plain " + name)
    return got, in_lens, lab_lens


def _assert_zero_outside(got, in_lens, lab_lens):
    _, d_blank, d_emit = got
    T, U1 = d_blank.shape[1:]
    for r in range(d_blank.shape[0]):
        t_out = torch.arange(T) >= max(int(in_lens[r]), 1)
        assert (d_blank[r, t_out] == 0).all() and (d_emit[r, t_out] == 0).all(), r
        assert (d_blank[r][:, torch.arange(U1) > lab_lens[r]] == 0).all(), r
        assert (d_emit[r][:, torch.arange(U1 - 1) >= lab_lens[r]] == 0).all(), r
    # the last row's loss has weight 0
    assert (d_blank[-1] == 0).all() and (d_emit[-1] == 0).all()
    assert d_blank[0].abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T,U", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernels_match_the_reference(cuda, name, B, T, U):
    got, in_lens, lab_lens = _check(B, T, U, seed=B + T + U, dev=cuda, oracle=U < 100)
    _assert_zero_outside(got, in_lens, lab_lens)


@pytest.mark.gpu
def test_kernels_at_the_transducer_cells_largest_shape(cuda):
    got, in_lens, lab_lens = _check(90, 383, 46, seed=383, dev=cuda, oracle=False)
    _assert_zero_outside(got, in_lens, lab_lens)


@pytest.mark.gpu
def test_bf16_lattice_through_rnnt_loss(cuda):
    """The training step's bf16 lattice: the lse and gathers, then the DP,
    against the same bf16 values through the plain path on the CPU."""
    rng = np.random.default_rng(7)
    B, T, U, V = 6, 40, 12, 96
    logits = torch.from_numpy(rng.normal(size=(B, T, U + 1, V))).bfloat16()
    targets = torch.from_numpy(rng.integers(1, V, (B, U)))
    in_lens = torch.from_numpy(rng.integers(1, T + 1, B))
    lab_lens = torch.from_numpy(rng.integers(0, U + 1, B))
    in_lens[0], lab_lens[0] = T, U

    def run(dev):
        lg = logits.to(dev).requires_grad_()
        loss = rnnt.rnnt_loss(lg, *(x.to(dev) for x in (targets, in_lens, lab_lens)))
        loss.sum().backward()
        return loss.detach().cpu().double(), lg.grad.cpu().double()

    before = rnnt.lattice_nll.launches
    (loss, grad), (want_loss, want_grad) = run(cuda), run(torch.device("cpu"))
    assert rnnt.lattice_nll.launches == before + 1
    np.testing.assert_allclose(loss.numpy(), want_loss.numpy(), rtol=1e-5)
    # the logits' gradient is bf16 and sums the blank's and the label's
    # terms: its rounding, plus the fp32 DP's delta, of its largest
    tol = (_grad_tol(T, U, want_loss)[0] + 2.0 ** -8) * float(want_grad.abs().max())
    np.testing.assert_allclose(grad.numpy(), want_grad.numpy(), atol=tol)


@pytest.mark.gpu
def test_no_host_sync_and_one_launch_each_way(cuda):
    lp_blank, lp_emit, in_lens, lab_lens, weights = _planes(8, 50, 20, seed=11)
    args = [x.float().to(cuda) for x in (lp_blank, lp_emit)] + [
        x.to(cuda) for x in (in_lens, lab_lens)]
    w = weights.float().to(cuda)
    _loss_and_grads(*args, w)  # builds and loads the library
    torch.cuda.synchronize()
    before = (rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches)
    b, e = (x.clone().requires_grad_() for x in args[:2])
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = rnnt.lattice_nll(b, e, *args[2:])
        (loss * w).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        rnnt.lattice_nll(*args)
    assert (rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.gpu
def test_wrong_planes_raise(cuda):
    lp_blank, lp_emit, in_lens, lab_lens, _ = _planes(3, 5, 4, seed=2)
    lens = [x.to(cuda) for x in (in_lens, lab_lens)]
    with pytest.raises(TypeError, match="lp_blank is torch.float64"):
        rnnt.lattice_nll(lp_blank.to(cuda), lp_emit.to(cuda), *lens)
    with pytest.raises(ValueError, match="lp_emit has shape"):
        rnnt.lattice_nll(lp_blank.float().to(cuda), lp_emit[:, :, 1:].float().to(cuda), *lens)
    with pytest.raises(ValueError, match="must be contiguous"):
        rnnt.lattice_nll(lp_blank.float().to(cuda), lp_emit.float().to(cuda).transpose(0, 1)
                         .contiguous().transpose(0, 1), *lens)


@pytest.mark.parametrize("name,B,T,U", SHAPES + [("largest", 90, 383, 46)],
                         ids=[s[0] for s in SHAPES] + ["largest"])
def test_the_gradient_limit_catches_planted_faults(name, B, T, U):
    """Slips a backward kernel could make, planted in the fp64 reference's
    gradients: each breaks the kernels' limit."""
    lp_blank, lp_emit, in_lens, lab_lens, weights = _planes(B, T, U, seed=B + T + U)
    loss, d_blank, d_emit = _loss_and_grads(lp_blank, lp_emit, in_lens, lab_lens, weights)
    rtol, atol = _grad_tol(T, U, loss)
    assert _within(d_blank, d_blank, rtol, atol) and _within(d_emit, d_emit, rtol, atol)
    other_logz = torch.exp(loss - loss.roll(1))[:, None, None]
    _, b_ones, e_ones = _loss_and_grads(lp_blank, lp_emit, in_lens, lab_lens,
                                        torch.ones_like(weights))
    faults = {"beta a frame late": (d_blank.roll(1, 1), d_emit),
              "another row's logZ": (d_blank * other_logz, d_emit * other_logz),
              "the cotangent left out": (b_ones, e_ones)}
    if U:  # a 0-label lattice has one path: its gradients are the weights
        faults["beta a label late"] = (d_blank, d_emit.roll(1, 2))
        flush = math.exp(-10)
        faults["gradients below e^-10 flushed"] = (
            torch.where(d_blank.abs() < flush, 0.0, d_blank),
            torch.where(d_emit.abs() < flush, 0.0, d_emit))
    for fault, (b, e) in faults.items():
        assert not (_within(b, d_blank, rtol, atol) and _within(e, d_emit, rtol, atol)), fault


def test_cpu_tensors_launch_nothing():
    lp_blank, lp_emit, in_lens, lab_lens, weights = _planes(4, 9, 5, seed=3)
    before = (rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches)
    loss, d_blank, _ = _loss_and_grads(lp_blank.float(), lp_emit.float(), in_lens, lab_lens,
                                       weights)
    assert torch.isfinite(loss).all() and d_blank.abs().sum() > 0
    assert (rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches) == before
