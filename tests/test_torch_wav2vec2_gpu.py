"""wav2vec 2.0's use of the attention kernels, without JAX (so the card,
which has no JAX, runs it with ``python -m pytest --noconftest -m gpu
tests/test_torch_wav2vec2_gpu.py``).

On the card (marker ``gpu``, skipped without CUDA): K1 at the two
validation shapes of the base configuration (12 heads of 64; 24 rows x 174
frames, the operating point's batch, and 8 rows x 774 frames, the
250,000-sample crop's), without a mask, against its plain version; a tiny
model's eval forward launches K1 once per layer and its train step none of
K1, K1', K2. On the CPU the same steps launch nothing.
"""

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.ops import flash_attention as fa

D = 64
SHAPES = {"step_batch": (288, 174), "long_crop": (96, 774)}  # (BH, T)
# fp32 differs from the plain version only in summation order; bf16 rounds
# P to bf16 before P V
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
TINY = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
            encoder_attention_heads=2, conv_feature_layers="[(32, 10, 5), (32, 8, 4)]",
            latent_vars=8, latent_groups=2, num_negatives=4, mask_length=3,
            mask_prob=0.5, conv_pos=4, conv_pos_groups=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k1_matches_plain_at_the_validation_shapes(cuda, dtype, tol, shape):
    bh, t = SHAPES[shape]
    rng = np.random.default_rng(bh)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, t, D)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, scale=D ** -0.5)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _launches(dev):
    """The (K1, K1', K2) launches of a tiny model's eval forward and of its
    train forward + backward."""
    from liteasr_tpu_torch.models.wav2vec2 import Wav2Vec2

    model = Wav2Vec2(**TINY, generator=torch.Generator().manual_seed(0)).to(dev)
    model.seed_dropout(0)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy((rng.normal(size=(3, 2000)) * 0.1).astype(np.float32)).to(dev)
    xlens = torch.tensor([2000, 1500, 0], device=dev)
    out = []
    for train in (False, True):
        before = (fa.flash_attention.launches, fa.flash_attention.lse_launches,
                  fa.flash_rel_attention_bwd.launches)
        with torch.set_grad_enabled(train):
            logits, mask, code_probs = model(xs, xlens, train=train)
            if train:
                logits[0].sum().backward()
        out.append(tuple(a - b for a, b in zip(
            (fa.flash_attention.launches, fa.flash_attention.lse_launches,
             fa.flash_rel_attention_bwd.launches), before)))
    return out


@pytest.mark.gpu
def test_eval_forward_launches_k1_per_layer(cuda):
    assert _launches(cuda) == [(2, 0, 0), (0, 0, 0)]


def test_cpu_forwards_take_the_plain_versions():
    assert _launches(torch.device("cpu")) == [(0, 0, 0), (0, 0, 0)]
