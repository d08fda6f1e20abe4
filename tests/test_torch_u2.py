"""liteasr_tpu_torch U2 against liteasr_tpu U2: one flax init carried across
with the bridge, the same numpy inputs, eval mode, fp32.

Also home of the tiny-model helpers the other ``test_torch_*`` parity
files import.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu.models.u2 import U2 as JaxU2
from liteasr_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from liteasr_tpu_torch.models.u2 import U2 as TorchU2

TOL = 2e-4
TINY = dict(input_dim=16, vocab_size=30, enc_dim=32, enc_ff_dim=64,
            enc_attn_heads=4, enc_layers=2, dec_dim=32, dec_ff_dim=64,
            dec_attn_heads=4, dec_layers=1)


def perturb(variables, seed: int, scale: float = 0.1):
    """Add noise to every leaf so that zero biases, unit norms and the
    BatchNorm running stats all carry information (var stays positive)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, path + (key,))
                continue
            arr = np.asarray(val, np.float32)
            noise = scale * rng.standard_normal(arr.shape).astype(np.float32)
            out[key] = np.abs(arr + noise) + 0.5 if key == "var" else arr + noise
        return out

    return walk(variables)


def build_pair(seed: int = 0, **overrides):
    """(jax model, numpy variables, torch model) with identical weights."""
    cfg = dict(TINY, **overrides)
    jmodel = JaxU2(**cfg)
    B, T = 2, 64
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((B, T, cfg["input_dim"])),
        jnp.full((B,), T), jnp.ones((B, 4), jnp.int32), jnp.full((B,), 4))
    variables = perturb(jax.device_get(variables), seed)
    tmodel = TorchU2(**cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def ragged_batch(seed: int, B: int = 3, T: int = 57, F: int = 16, L: int = 6,
                 V: int = 30):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, T, F)).astype(np.float32)
    xlens = np.array([T, T - 13, 19][:B], np.int32)
    ys = rng.integers(1, V - 1, size=(B, L)).astype(np.int32)
    ylens = np.array([L, 3, 1][:B], np.int32)
    ys[np.arange(L)[None, :] >= ylens[:, None]] = -1
    return xs, xlens, ys, ylens


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    return build_pair(0)


def test_bridge_round_trip_is_exact(pair):
    _, variables, tmodel = pair
    sd = tmodel.state_dict()
    assert set(flax_to_state_dict(variables)) == set(sd)
    back = state_dict_to_flax(sd)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_encode_and_ctc_match(normalize_before):
    jmodel, variables, tmodel = build_pair(1, normalize_before=normalize_before)
    xs, xlens, _, _ = ragged_batch(1)
    j_enc, j_mask = jmodel.apply(variables, xs, xlens, method=jmodel.encode)
    j_ctc = jmodel.apply(variables, j_enc, method=jmodel.ctc_logits)
    with torch.no_grad():
        h_enc, mask = tmodel.encode(t(xs), t(xlens))
        ctc = tmodel.ctc_logits(h_enc)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(h_enc.numpy(), np.asarray(j_enc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ctc.numpy(), np.asarray(j_ctc), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        tmodel.get_pred_len(t(xlens)).numpy(),
        np.asarray(jmodel.get_pred_len(jnp.asarray(xlens))))


def test_decode_logits_match(pair):
    jmodel, variables, tmodel = pair
    xs, xlens, ys, ylens = ragged_batch(2)
    j_enc, j_mask = jmodel.apply(variables, xs, xlens, method=jmodel.encode)
    L = ys.shape[1] + 1
    ys_in = np.concatenate([np.full((3, 1), 29, np.int32), np.maximum(ys, 0)], 1)
    pad = np.arange(L)[None, :] >= (ylens + 1)[:, None]
    causal = np.triu(np.ones((L, L), bool), 1)
    mask = pad[:, None, :] | causal[None]
    j_logits = jmodel.apply(variables, ys_in, j_enc, mask, j_mask,
                            method=jmodel.decode_logits)
    with torch.no_grad():
        logits = tmodel.decode_logits(t(ys_in).long(), t(np.asarray(j_enc)),
                                      t(mask), t(np.asarray(j_mask)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)


def test_forward_matches(pair):
    jmodel, variables, tmodel = pair
    xs, xlens, ys, ylens = ragged_batch(3)
    j_attn, j_ctc = jmodel.apply(variables, xs, xlens, ys, ylens)
    with torch.no_grad():
        h_attn, h_ctc = tmodel(t(xs), t(xlens), t(ys).long(), t(ylens))
    np.testing.assert_allclose(h_attn.numpy(), np.asarray(j_attn), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h_ctc.numpy(), np.asarray(j_ctc), rtol=TOL, atol=TOL)
