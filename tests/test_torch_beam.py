"""liteasr_tpu_torch's attention beam search against liteasr_tpu's, on the
CPU in fp32 at tiny widths, one flax init carried across by the bridge:
the decoder's KV-cache step against its full forward, the cached and the
recompute beams of both packages (identical best hypotheses and lengths;
the port's best score within 1e-5 of the JAX best hypothesis's score
recomputed by teacher forcing), beams that finish early, and
``decode_batch(mode="attention")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu import decode as jdecode
from liteasr_tpu_torch import decode as tdecode
from liteasr_tpu_torch.bridge import flax_to_state_dict

from test_torch_u2 import build_pair, ragged_batch, t

SCORE_TOL = 1e-5
V = 30  # test_torch_u2.TINY vocab; sos = eos = 29


def _pair(seed: int, eos_bias: float = 0.0):
    """The tiny model with peaked decoder posteriors (``linear_out`` scaled
    by 4 in both trees); ``eos_bias`` raises eos's logit so that beams
    finish early."""
    jmodel, variables, tmodel = build_pair(seed)
    out = variables["params"]["decoder"]["linear_out"]
    out["kernel"] = out["kernel"] * 4.0
    out["bias"] = out["bias"] * 4.0
    out["bias"][V - 1] += eos_bias
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel


def _encode(jmodel, variables, seed):
    xs, xlens, _, _ = ragged_batch(seed)
    h_enc, enc_mask = jmodel.apply(variables, xs, xlens, method=jmodel.encode)
    return np.asarray(h_enc), np.asarray(enc_mask)


def _teacher_forced_score(jmodel, variables, h_enc, enc_mask, body, lens):
    """Sum of the decoder's log-probs of each best hypothesis's tokens, its
    eos included when it finished (the beam's score)."""
    B, L = body.shape
    ys_in = np.concatenate([np.full((B, 1), V - 1, np.int64), body], axis=1)
    causal = np.triu(np.ones((L + 1, L + 1), bool), 1)[None]
    logits = jmodel.apply(variables, ys_in, h_enc, causal, enc_mask,
                          method=jmodel.decode_logits)
    logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))
    out = []
    for b in range(B):
        n = min(int(lens[b]) + 1, L)  # the tokens and the first eos
        out.append(sum(logp[b, j, body[b, j]] for j in range(n)))
    return np.array(out)


def test_decoder_step_matches_the_full_forward():
    """prime + step at each position equals the full decoder's logits of
    that position under the causal mask."""
    _, _, tmodel = _pair(1)
    rng = np.random.default_rng(1)
    B, Tp, L = 3, 9, 6
    h_enc = t(rng.normal(size=(B, Tp, 32)).astype(np.float32))
    enc_mask = t(np.arange(Tp)[None, :] >= np.array([9, 5, 2])[:, None])
    ys = t(rng.integers(0, V, size=(B, L))).long()
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool), 1)[None]
    with torch.no_grad():
        full = tmodel.decode_logits(ys, h_enc, causal, enc_mask)
        src_kv = tmodel.decode_prime(h_enc)
        caches = [(torch.zeros(B, L, 4, 8), torch.zeros(B, L, 4, 8)) for _ in src_kv]
        for i in range(L):
            step = tmodel.decode_step(ys[:, i], src_kv, caches, i, enc_mask)
            np.testing.assert_allclose(step.numpy(), full[:, i].numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,eos_bias", [(2, 0.0), (5, 9.0)])
def test_cached_beam_equals_recompute_beam(seed, eos_bias):
    jmodel, variables, tmodel = _pair(seed, eos_bias)
    h_enc, enc_mask = _encode(jmodel, variables, seed)
    with torch.no_grad():
        cached = tdecode.attention_beam_search(tmodel, t(h_enc), t(enc_mask), 4)
        recomputed = tdecode.attention_beam_search(
            tmodel, t(h_enc), t(enc_mask), 4, use_cache=False)
    np.testing.assert_array_equal(cached[0].numpy(), recomputed[0].numpy())
    np.testing.assert_array_equal(cached[1].numpy(), recomputed[1].numpy())
    np.testing.assert_allclose(cached[2].numpy(), recomputed[2].numpy(),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("seed,eos_bias,beam", [(4, 0.0, 4), (5, 9.0, 3), (6, 9.0, 5)])
def test_beam_matches_jax(seed, eos_bias, beam, use_cache):
    """eos_bias 9 makes beams finish within a few steps (the finished
    beams' (eos, +0) candidate and the ties among dead -inf beams)."""
    jmodel, variables, tmodel = _pair(seed, eos_bias)
    h_enc, enc_mask = _encode(jmodel, variables, seed)
    j_body, j_lens = jdecode.attention_beam_search(
        jmodel, variables, jnp.asarray(h_enc), jnp.asarray(enc_mask),
        beam_size=beam, use_cache=use_cache)
    j_body, j_lens = np.asarray(j_body), np.asarray(j_lens)
    with torch.no_grad():
        body, lens, scores = tdecode.attention_beam_search(
            tmodel, t(h_enc), t(enc_mask), beam, use_cache=use_cache)
    np.testing.assert_array_equal(lens.numpy(), j_lens)
    np.testing.assert_array_equal(body.numpy(), j_body)
    ref = _teacher_forced_score(jmodel, variables, h_enc, enc_mask, j_body, j_lens)
    assert np.isfinite(scores.numpy()).all()
    np.testing.assert_allclose(scores.numpy(), ref, rtol=SCORE_TOL, atol=SCORE_TOL)
    if eos_bias > 0.0:  # the early-finish cases really finished early
        assert (j_lens < j_body.shape[1]).any()


def test_decode_batch_attention_matches_jax():
    jmodel, variables, tmodel = _pair(5, 9.0)
    xs, xlens, _, _ = ragged_batch(5)
    ref = jdecode.decode_batch(jmodel, variables, jnp.asarray(xs),
                               jnp.asarray(xlens), beam_size=4, mode="attention")
    hyps = tdecode.decode_batch(tmodel, t(xs), t(xlens), beam_size=4,
                                mode="attention")
    assert hyps == ref
