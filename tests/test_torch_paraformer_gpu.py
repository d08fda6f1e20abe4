"""The Paraformer's use of the attention kernels, without JAX (so the card,
which has no JAX, runs it with ``python -m pytest --noconftest -m gpu
tests/test_torch_paraformer_gpu.py``).

On the card (marker ``gpu``, skipped without CUDA): K1 at the parallel
decoder's shapes (pass 1 of a training step: self-attention without a mask
at 48 x 48, source attention with ``kv_lens`` at 48 x 199; decoding: 399 x
399 without a mask and with ``kv_lens``) against its plain version, and a
tiny train step's launches. On the CPU: the same step takes the plain
versions and launches nothing, and pass 1's outputs stay out of the graph.
"""

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.ops import flash_attention as fa

D = 64
# (BH, Tq, Tk, kv_lens?): pass 1 at bench.py's point (B=32 x 4 heads, U=48,
# T'=199) and a decoded batch (B=16 x 4 heads, T'=399)
SHAPES = {"pass1_self": (128, 48, 48, False), "pass1_src": (128, 48, 199, True),
          "decode_self": (64, 399, 399, False), "decode_src": (64, 399, 399, True)}
# fp32 differs from the plain version only in summation order; bf16 rounds
# P to bf16 before P V
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
TINY = dict(input_dim=16, vocab_size=12, enc_dim=32, enc_ff_dim=64, enc_attn_heads=2,
            enc_layers=2, dec_dim=32, dec_ff_dim=64, dec_attn_heads=2, dec_layers=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape: str, dev, dtype):
    bh, tq, tk, lens = SHAPES[shape]
    rng = np.random.default_rng(sorted(SHAPES).index(shape))
    args = {n: torch.from_numpy(rng.normal(size=(bh, t, D)).astype(np.float32)).to(dev, dtype)
            for n, t in (("q", tq), ("k", tk), ("v", tk))}
    if lens:
        kv = rng.integers(tk // 2, tk + 1, size=bh // 4).repeat(4)
        kv[:4] = tk
        args["kv_lens"] = torch.from_numpy(kv.astype(np.int32)).to(dev)
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k1_matches_plain_at_the_decoder_shapes(cuda, dtype, tol, shape):
    args = _inputs(shape, cuda, dtype)
    before = fa.flash_attention.launches
    out = fa.flash_attention(scale=D ** -0.5, **args)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(scale=D ** -0.5, **args)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _tiny_step(dev):
    """One train-mode forward and backward of a tiny Paraformer (2 encoder
    layers, 1 decoder layer) in fp32; returns the model and the launches
    (K1 and K1', K1', K2) it made."""
    from liteasr_tpu_torch.models.paraformer import Paraformer

    model = Paraformer(**TINY, generator=torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(3, 57, 16)).astype(np.float32)).to(dev)
    xlens = torch.tensor([57, 44, 19], device=dev)
    ys = torch.tensor([[1, 2, 3, 4], [5, 6, -1, -1], [7, -1, -1, -1]], device=dev)
    ylens = torch.tensor([4, 2, 1], device=dev)
    before = (fa.flash_attention.launches, fa.flash_attention.lse_launches,
              fa.flash_rel_attention_bwd.launches)
    out, sum_alpha = model(xs, xlens, ys, ylens, train=True)
    (out.float().square().mean() + sum_alpha.sum()).backward()
    after = (fa.flash_attention.launches, fa.flash_attention.lse_launches,
             fa.flash_rel_attention_bwd.launches)
    return model, tuple(a - b for a, b in zip(after, before))


@pytest.mark.gpu
def test_train_step_launches_on_the_card(cuda):
    """Per encoder layer one K1' and one K2; per decoder layer two K1 in
    pass 1 (pass 2 trains: plain attention)."""
    model, launches = _tiny_step(cuda)
    torch.cuda.synchronize()
    assert launches == (2 + 2, 2, 2)
    assert all(p.grad is not None for p in model.predictor.parameters())


def test_cpu_step_takes_the_plain_versions():
    """On the CPU the same step launches nothing, and pass 1 (eval mode,
    no_grad) leaves no K1 output in the graph: every parameter the step
    trains still gets a gradient, the predictor's among them."""
    model, launches = _tiny_step(torch.device("cpu"))
    assert launches == (0, 0, 0)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    assert float(model.predictor.conv.weight.grad.abs().max()) > 0
