"""liteasr_tpu_torch's training attention: K1' (lse + dropout), K2 (the
backward) and K3 (the autograd.Function joining them).

On the CPU: the plain versions against the JAX package's Pallas kernels in
interpret mode, as tests/test_flash_attention.py runs them, at one tile
(T=48) and two tiles (T=200, where the dropout hash's tile coordinates and
the dQ_v crossover between query tiles matter), with a kv_len=0 row. On the
card (marker ``gpu``, skipped without CUDA): the CUDA kernels against the
plain versions. JAX is imported only inside the CPU tests, so the card can
run this file with ``python -m pytest --noconftest -m gpu``.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.ops import flash_attention as fa

TOL = 5e-4  # tests/test_flash_attention.py:142-229
B, H, D = 2, 2, 32


def _inputs(seed: int, t: int, d: int = D, b: int = B, h: int = H):
    rng = np.random.default_rng(seed)
    bh = b * h

    def mk(*shape):
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    kv = np.resize(np.array([t, t - 9, 0, t - 31], np.int32), bh)  # row 2 is dead
    return dict(q_u=mk(bh, t, d), qv=mk(bh, t, d), k=mk(bh, t, d),
                v=mk(bh, t, d), p=mk(h, t, d), kv_lens=kv,
                dout=mk(bh, t, d))


@pytest.mark.parametrize("rate", [0.1, 0.3, 1e-12])
@pytest.mark.parametrize("b,qi,kj,seed", [(0, 0, 0, 0), (3, 1, 0, 123),
                                          (127, 1, 1, -5), (7, 0, 1, 2**31 - 1)])
def test_dropout_keep_is_bit_equal(rate, b, qi, kj, seed):
    import jax.numpy as jnp

    from liteasr_tpu.ops.flash_attention import _dropout_keep

    ref = np.asarray(_dropout_keep(128, 128, b, qi, kj,
                                   jnp.asarray(seed, jnp.int32), rate))
    got = fa.dropout_keep_plain(128, 128, b, qi, kj, seed, rate).numpy()
    np.testing.assert_array_equal(got, ref)
    if rate == 1e-12:
        assert got.all()


def _jax_train(x, seed, rate, scale):
    """JAX value and five grads of sum(out * dout), p tiled per bh row."""
    import jax
    import jax.numpy as jnp

    from liteasr_tpu.ops.flash_attention import flash_rel_attention_train

    bh = x["q_u"].shape[0]
    p_full = np.tile(x["p"], (bh // x["p"].shape[0], 1, 1))
    kv = jnp.asarray(x["kv_lens"])
    dout = jnp.asarray(x["dout"])
    args = [jnp.asarray(x[n]) for n in ("q_u", "qv", "k", "v")] + [jnp.asarray(p_full)]

    def f(*a):
        return flash_rel_attention_train(*a, kv, jnp.asarray(seed, jnp.int32),
                                         scale, rate, True)

    out = f(*args)
    grads = jax.grad(lambda *a: (f(*a) * dout).sum(), argnums=(0, 1, 2, 3, 4))(*args)
    grads = [np.asarray(g) for g in grads]
    # the port shares p over the batch: its grad is the sum of the rows
    hp = x["p"].shape[0]
    grads[4] = grads[4].reshape(bh // hp, hp, *grads[4].shape[1:]).sum(0)
    return np.asarray(out), grads


def _torch_train(x, seed, rate, scale, device="cpu", dtype=torch.float32):
    args = [torch.from_numpy(x[n]).to(device, dtype).requires_grad_()
            for n in ("q_u", "qv", "k", "v", "p")]
    out = fa.flash_rel_attention_train(
        *args, torch.from_numpy(x["kv_lens"]).to(device), seed, scale, rate)
    (out * torch.from_numpy(x["dout"]).to(device)).sum().backward()
    return out.detach(), [a.grad for a in args]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("t", [48, 200])
def test_k3_plain_matches_pallas_interpret(t, rate):
    x = _inputs(t, t)
    scale, seed = D ** -0.5, 77
    j_out, j_grads = _jax_train(x, seed, rate, scale)
    out, grads = _torch_train(x, seed, rate, scale)
    live = x["kv_lens"] > 0
    np.testing.assert_allclose(out.numpy()[live], j_out[live], rtol=TOL, atol=TOL)
    for name, g, jg in zip(("q_u", "qv", "k", "v", "p"), grads, j_grads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=TOL, atol=TOL, err_msg=name)
        if name != "p":  # p is shared with the live rows
            assert (g.numpy()[~live] == 0).all(), name
            assert (jg[~live] == 0).all(), name


def test_dead_row_output_is_the_reference_uniform_row():
    """A kv_len=0 row: every key masked. The port gives the XLA reference's
    uniform softmax row, like K1 (the Pallas kernel's value there depends on
    its key padding); its gradients are exactly 0 above."""
    import jax.numpy as jnp

    from liteasr_tpu.ops.flash_attention import _ref_rel_attention

    x = _inputs(3, 48)
    bh = x["q_u"].shape[0]
    p_full = np.tile(x["p"], (bh // H, 1, 1))
    ref = np.asarray(_ref_rel_attention(
        *(jnp.asarray(x[n]) for n in ("q_u", "qv", "k", "v")),
        jnp.asarray(p_full), jnp.asarray(x["kv_lens"]), D ** -0.5))
    out, _ = _torch_train(x, 0, 0.0, D ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_lse_matches_pallas_interpret(rate):
    import jax.numpy as jnp

    from liteasr_tpu.ops.flash_attention import flash_attention as jax_flash

    x = _inputs(5, 200)
    bh = x["q_u"].shape[0]
    p_full = np.tile(x["p"], (bh // H, 1, 1))
    j_out, j_lse = jax_flash(
        jnp.asarray(x["q_u"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        kv_lens=jnp.asarray(x["kv_lens"]), rel_qv=jnp.asarray(x["qv"]),
        rel_p=jnp.asarray(p_full), scale=D ** -0.5, interpret=True,
        return_lse=True, dropout_rate=rate, dropout_seed=jnp.asarray(9, jnp.int32))
    out, lse = fa.flash_attention(
        *(torch.from_numpy(x[n]) for n in ("q_u", "k", "v")),
        kv_lens=torch.from_numpy(x["kv_lens"]), rel_qv=torch.from_numpy(x["qv"]),
        rel_p=torch.from_numpy(x["p"]), scale=D ** -0.5, return_lse=True,
        dropout_rate=rate, dropout_seed=9)
    live = x["kv_lens"] > 0
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(j_lse)[live],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy()[live], np.asarray(j_out)[live],
                               rtol=TOL, atol=TOL)
    assert (lse.numpy()[~live] == fa.NEG_INF).all()
    assert (np.asarray(j_lse)[~live] <= fa.NEG_INF / 2).all()


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_backward_equals_autograd(rate):
    """The closed-form backward equals torch autograd through the plain
    forward. The dead row's cotangent is 0 here: autograd would send it
    through the uniform row into dV, where the kernels (JAX's too) give 0."""
    x = _inputs(11, 40)
    x["dout"][x["kv_lens"] == 0] = 0.0
    scale, seed = D ** -0.5, 4
    args = [torch.from_numpy(x[n]).double().requires_grad_()
            for n in ("q_u", "qv", "k", "v", "p")]
    kv = torch.from_numpy(x["kv_lens"])
    dout = torch.from_numpy(x["dout"]).double()
    out, lse = fa.flash_attention_plain(
        args[0], args[2], args[3], kv_lens=kv, rel_qv=args[1], rel_p=args[4],
        scale=scale, return_lse=True, dropout_rate=rate, dropout_seed=seed)
    (out * dout).sum().backward()
    grads = fa.flash_rel_attention_bwd_plain(
        *(a.detach() for a in args), kv, out.detach(), lse, dout, scale,
        rate, seed)
    for name, a, g in zip(("q_u", "qv", "k", "v", "p"), args, grads):
        torch.testing.assert_close(g.double(), a.grad, rtol=1e-5, atol=1e-6,
                                   msg=name)


def test_cpu_tensors_take_the_plain_versions():
    x = _inputs(13, 24)
    f_before = fa.flash_attention.launches
    b_before = fa.flash_rel_attention_bwd.launches
    _torch_train(x, 1, 0.1, D ** -0.5)
    assert fa.flash_attention.launches == f_before
    assert fa.flash_rel_attention_bwd.launches == b_before


def test_train_rel_attention_takes_k3_and_refuses_chunk_masks():
    """A padding mask and a chunk width go through K3 (the chunk policy as
    the integer, never as a mask); a materialized structured mask (here the
    causal one) has no kernel and raises."""
    from liteasr_tpu_torch.nets.attention import RelativeMultiHeadAttention

    torch.manual_seed(0)
    attn = RelativeMultiHeadAttention(16, 2, dropout_rate=0.1)
    x, pos = torch.randn(2, 6, 16), torch.randn(1, 6, 16)
    pad = torch.zeros(2, 1, 1, 6, dtype=torch.bool)
    pad[1, ..., 4:] = True
    with mock.patch.object(attn, "_flash_train", wraps=attn._flash_train) as k3:
        assert attn(x, x, x, pos, pad, train=True).shape == (2, 6, 16)
        assert attn(x, x, x, pos, pad, train=True, chunk=2).shape == (2, 6, 16)
    assert k3.call_count == 2 and k3.call_args.args[-1] == 2
    causal = torch.ones(6, 6, dtype=torch.bool).triu(1)[None, None]
    with pytest.raises(NotImplementedError, match="structured mask"):
        attn(x, x, x, pos, causal, train=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (dtype, forward tol, grad tol): fp32 differs from the plain version in
# summation order and atomics; bf16 rounds P to bf16 before P V in the
# forward, as the TPU kernel does, and the grads are cast to bf16.
DTYPES = [(torch.float32, 1e-4, 1e-3), (torch.bfloat16, 2e-2, 5e-2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ftol,gtol", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t,d,b,h", [(48, 32, 2, 2), (199, 64, 2, 4),
                                     (130, 100, 1, 2), (64, 64, 2, 2),
                                     (65, 128, 2, 2), (128, 32, 2, 2),
                                     (129, 128, 1, 4), (399, 64, 2, 2)])
def test_kernels_match_plain(cuda, dtype, ftol, gtol, rate, t, d, b, h):
    x = _inputs(17, t, d, b, h)
    if b * h > 3:  # a kv_len=1 row beside the kv_len=0 row (row 2)
        x["kv_lens"][3] = 1
    scale, seed = d ** -0.5, 2024
    f0, l0 = fa.flash_attention.launches, fa.flash_attention.lse_launches
    b0 = fa.flash_rel_attention_bwd.launches
    out, grads = _torch_train(x, seed, rate, scale, cuda, dtype)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == f0 + 1
    assert fa.flash_attention.lse_launches == l0 + 1
    assert fa.flash_rel_attention_bwd.launches == b0 + 1
    ins = [torch.from_numpy(x[n]).to(cuda, dtype)
           for n in ("q_u", "qv", "k", "v", "p")]
    kv = torch.from_numpy(x["kv_lens"]).to(cuda)
    ref_out, ref_lse = fa.flash_attention_plain(
        ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4],
        scale=scale, return_lse=True, dropout_rate=rate, dropout_seed=seed)
    torch.testing.assert_close(out, ref_out.float(), rtol=ftol, atol=ftol)
    ref_grads = fa.flash_rel_attention_bwd_plain(
        *ins, kv, out, ref_lse, torch.from_numpy(x["dout"]).to(cuda), scale,
        rate, seed)
    for name, g, r in zip(("q_u", "qv", "k", "v", "p"), grads, ref_grads):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r, rtol=gtol, atol=gtol, msg=name)
