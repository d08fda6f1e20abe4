"""liteasr_tpu_torch layers against their flax counterparts in eval mode,
fp32: the same flax init (perturbed, so biases, norms and BatchNorm running
stats are non-trivial) carried across with the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu.nets import attention as jattn
from liteasr_tpu.nets import layers as jlayers
from liteasr_tpu.nets.common import sinusoidal_pe as jax_pe
from liteasr_tpu.nets.subsampling import Conv2DSubsampling as JaxSubsampling
from liteasr_tpu_torch.bridge import flax_to_state_dict
from liteasr_tpu_torch.nets import attention as tattn
from liteasr_tpu_torch.nets import layers as tlayers
from liteasr_tpu_torch.nets.common import sinusoidal_pe
from liteasr_tpu_torch.nets.subsampling import Conv2DSubsampling

from test_torch_u2 import perturb, t

TOL = 1e-4
B, T, D, H, FF = 2, 23, 32, 4, 64


def _run(jmodule, tmodule, args, seed):
    variables = jmodule.init({"params": jax.random.PRNGKey(seed)}, *args)
    variables = perturb(jax.device_get(variables), seed)
    tmodule.load_state_dict(flax_to_state_dict(variables), strict=True)
    ref = jmodule.apply(variables, *args)
    with torch.no_grad():
        out = tmodule(*(None if a is None else t(a) for a in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _data(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    pad = np.arange(T)[None, :] >= np.array([T, 14])[:, None]
    return rng, x, pad[:, None, None, :]


def test_sinusoidal_pe_interleaved():
    np.testing.assert_allclose(sinusoidal_pe(T, D).numpy(),
                               np.asarray(jax_pe(T, D)), rtol=1e-6, atol=1e-6)


def test_conv2d_subsampling():
    x = np.random.default_rng(0).normal(size=(B, 61, 16)).astype(np.float32)
    _run(JaxSubsampling(D), Conv2DSubsampling(16, D), (x,), 0)


def test_rel_attention():
    rng, x, pad = _data(1)
    pos = np.asarray(jax_pe(T, D))
    _run(jattn.RelativeMultiHeadAttention(H, 0.0),
         tattn.RelativeMultiHeadAttention(D, H), (x, x, x, pos, pad), 1)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_conformer_layer(normalize_before):
    rng, x, pad = _data(2)
    pos = np.asarray(jax_pe(T, D))
    _run(jlayers.ConformerLayer(H, FF, 0.0, 0.0, 0.0,
                                normalize_before=normalize_before),
         tlayers.ConformerLayer(D, H, FF, normalize_before=normalize_before),
         (x, pos, pad), 2)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_encoder_layer(normalize_before):
    rng, x, pad = _data(3)
    _run(jlayers.EncoderLayer(H, FF, 0.0, 0.0, 0.0, activation="swish",
                              normalize_before=normalize_before),
         tlayers.EncoderLayer(D, H, FF, "swish",
                              normalize_before=normalize_before),
         (x, None, pad), 3)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_decoder_layer(normalize_before):
    rng, mem, mem_pad = _data(4)
    L = 9
    y = rng.normal(size=(B, L, D)).astype(np.float32)
    ypad = np.arange(L)[None, :] >= np.array([L, 4])[:, None]
    mask = (ypad[:, None, :] | np.triu(np.ones((L, L), bool), 1)[None])[:, None]
    _run(jlayers.DecoderLayer(H, FF, 0.0, 0.0, 0.0, 0.0,
                              normalize_before=normalize_before),
         tlayers.DecoderLayer(D, H, FF, normalize_before=normalize_before),
         (y, mem, mask, mem_pad), 4)
