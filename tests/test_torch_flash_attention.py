"""liteasr_tpu_torch's attention (kernel K1 and its plain version).

On the CPU: the plain version against the JAX package's Pallas kernel in
interpret mode, as tests/test_flash_attention.py runs it, at sizes that are
not tile multiples. On the card (marker ``gpu``, skipped without CUDA): the
CUDA kernel against the plain version. This file imports JAX only inside the
CPU tests, so the card, which has no JAX, can run it with
``python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py``.
"""

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.ops import flash_attention as fa

TOL = 3e-4  # tests/test_flash_attention.py:105
B, H, T, D = 2, 3, 50, 32


def _inputs(seed: int, tq: int = T, tk: int = T, d: int = D):
    rng = np.random.default_rng(seed)
    bh = B * H

    def mk(*shape):
        return rng.normal(size=shape).astype(np.float32)

    mask = rng.random((B, tq, tk)) < 0.3
    mask[:, :, 0] = False  # at least one key per query
    return dict(q=mk(bh, tq, d), k=mk(bh, tk, d), v=mk(bh, tk, d),
                rel_qv=mk(bh, tq, d), rel_p=mk(H, tk, d), mask=mask,
                kv_lens=np.array([tk, 33, 17, 1, tk - 1, 9][:bh], np.int32))


CASES = {
    "kv_lens": ("kv_lens",),
    "rel_kv_lens": ("kv_lens", "rel_qv", "rel_p"),
    "mask": ("mask",),
}
KERNEL_CASES = dict(CASES, none=(),
                    rel_mask_kv_lens=("kv_lens", "mask", "rel_qv", "rel_p"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    import jax.numpy as jnp

    from liteasr_tpu.ops.flash_attention import flash_attention as jax_flash

    x = _inputs(0)
    used = CASES[case]
    scale = D ** -0.5
    j_args = {}
    if "kv_lens" in used:
        j_args["kv_lens"] = jnp.asarray(x["kv_lens"])
    if "rel_qv" in used:  # the JAX kernel takes the table per (b, h) row
        j_args["rel_qv"] = jnp.asarray(x["rel_qv"])
        j_args["rel_p"] = jnp.asarray(np.tile(x["rel_p"], (B, 1, 1)))
    if "mask" in used:
        j_args["mask"] = jnp.asarray(np.repeat(x["mask"], H, axis=0))
    ref = jax_flash(jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
                    scale=scale, tq=16, tk=16, interpret=True, **j_args)
    out = fa.flash_attention(
        torch.from_numpy(x["q"]), torch.from_numpy(x["k"]),
        torch.from_numpy(x["v"]), scale=scale,
        **{name: torch.from_numpy(x[name]) for name in used})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t1,t2", [(7, 7), (5, 9)])
def test_rel_shift_matches_reference(t1, t2):
    import jax.numpy as jnp

    from liteasr_tpu.nets.attention import rel_shift

    x = np.random.default_rng(1).normal(size=(2, 3, t1, t2)).astype(np.float32)
    np.testing.assert_array_equal(
        fa.rel_shift(torch.from_numpy(x)).numpy(),
        np.asarray(rel_shift(jnp.asarray(x))))


def test_cpu_tensors_take_the_plain_version():
    x = _inputs(2)
    before = fa.flash_attention.launches
    out = fa.flash_attention(*(torch.from_numpy(x[n]) for n in "qkv"))
    assert fa.flash_attention.launches == before
    ref = fa.flash_attention_plain(*(torch.from_numpy(x[n]) for n in "qkv"))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (dtype, tolerance): fp32 differs from the plain version only in summation
# order; bf16 rounds P to bf16 before P V, as the TPU kernel does.
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
@pytest.mark.parametrize("tq,d", [(50, 32), (130, 64), (64, 100), (64, 64), (65, 128),
                                  (128, 32), (129, 128), (399, 64)])
def test_kernel_matches_plain(cuda, dtype, tol, case, tq, d):
    x = _inputs(3, tq, tq, d)
    used = KERNEL_CASES[case]
    args = {n: torch.from_numpy(x[n]).to(cuda) for n in ("q", "k", "v") + used}
    for n in ("q", "k", "v", "rel_qv", "rel_p"):
        if n in args:
            args[n] = args[n].to(dtype)
    before = fa.flash_attention.launches
    out = fa.flash_attention(scale=d ** -0.5, **args)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(scale=d ** -0.5, **args)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rel", [False, True])
def test_kernel_skips_key_tiles_past_kv_len(cuda, dtype, tol, rel):
    """The kernel walks a row's keys only up to kv_len (a kv_len=0 row walks
    them all: its output is the mean of V); every row equals the plain
    version."""
    t, d = 399, 64
    x = _inputs(4, t, t, d)
    kv = torch.tensor([t, 1, 0, 64, 65, 200], dtype=torch.int32, device=cuda)
    args = {n: torch.from_numpy(x[n]).to(cuda, dtype)
            for n in ("q", "k", "v") + (("rel_qv", "rel_p") if rel else ())}
    out, lse = fa.flash_attention(scale=d ** -0.5, kv_lens=kv, return_lse=True, **args)
    ref, ref_lse = fa.flash_attention_plain(scale=d ** -0.5, kv_lens=kv,
                                            return_lse=True, **args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)
    assert (lse[2] == fa.NEG_INF).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rel", [False, True])
def test_kernel_skips_key_tiles_the_mask_hides(cuda, dtype, tol, rel):
    """Key tiles that the bool mask hides from every row of a query tile are
    skipped. Batch 0 is causal; in batch 1 the rows of the second query tile
    see only keys >= 140 (their first real score comes after two skipped
    tiles) and row 5 sees no key (its output is the mean of V, so its block
    walks every tile again). Every row equals the plain version."""
    t, d = 200, 64
    x = _inputs(5, t, t, d)
    j = np.arange(t)
    mask = np.zeros((B, t, t), bool)
    mask[0] = j[None, :] > j[:, None]
    mask[1, 64:128, :140] = True
    mask[1, 5] = True
    args = {n: torch.from_numpy(x[n]).to(cuda, dtype)
            for n in ("q", "k", "v") + (("rel_qv", "rel_p") if rel else ())}
    args["mask"] = torch.from_numpy(mask).to(cuda)
    out, lse = fa.flash_attention(scale=d ** -0.5, return_lse=True, **args)
    ref, ref_lse = fa.flash_attention_plain(scale=d ** -0.5, return_lse=True, **args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)
