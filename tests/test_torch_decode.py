"""liteasr_tpu_torch decoding against liteasr_tpu's: CTC prefix beam search
on the same log-probs (and against the reference's dict oracle), and
attention rescoring / decode_batch token-exact on the same bridged model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu import decode as jdecode
from liteasr_tpu_torch import decode as tdecode
from liteasr_tpu_torch.bridge import flax_to_state_dict

from test_decode import oracle_prefix_beam
from test_torch_u2 import build_pair, ragged_batch, t

SCORE_TOL = 1e-5


def _logp(seed, B=3, T=12, V=6, scale=2.0):
    logits = np.random.default_rng(seed).normal(size=(B, T, V)).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits * scale), axis=-1))


@pytest.mark.parametrize("seed,K", [(0, 4), (1, 3), (2, 6)])
def test_prefix_beam_matches_jax_and_oracle(seed, K):
    logp = _logp(seed)
    B, T, _ = logp.shape
    enc_lens = np.array([T, T - 3, T - 6], np.int32)
    j_pre, j_len, j_score = map(np.asarray, jdecode.ctc_prefix_beam_search(
        jnp.asarray(logp), jnp.asarray(enc_lens), beam_size=K))
    pre, plen, score = tdecode.ctc_prefix_beam_search(
        t(logp), t(enc_lens), beam_size=K)
    np.testing.assert_array_equal(plen.numpy(), j_len)
    for b in range(B):
        for k in range(K):
            assert pre[b, k, :plen[b, k]].tolist() == j_pre[b, k, :j_len[b, k]].tolist()
    np.testing.assert_allclose(score.numpy(), j_score, rtol=SCORE_TOL, atol=SCORE_TOL)
    for b in range(B):
        oracle = oracle_prefix_beam(logp[b, :enc_lens[b]], K)
        for k, (o_pre, o_score) in enumerate(oracle):
            assert tuple(pre[b, k, :plen[b, k]].tolist()) == o_pre
            np.testing.assert_allclose(score[b, k].item(), o_score, rtol=1e-4, atol=1e-4)


def test_ctc_greedy_matches_jax():
    logp = _logp(3)
    enc_lens = np.array([12, 7, 1], np.int32)
    j_ids, j_keep = jdecode.ctc_greedy(jnp.asarray(logp), jnp.asarray(enc_lens))
    ids, keep = tdecode.ctc_greedy(t(logp), t(enc_lens))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))


@pytest.fixture(scope="module")
def peaked_pair():
    """The tiny model with ``ctc_lo`` and ``linear_out`` scaled alike in both
    trees, so the posteriors are peaked and beams rarely tie."""
    jmodel, variables, tmodel = build_pair(5)
    params = variables["params"]
    for mod in (params["ctc_lo"], params["decoder"]["linear_out"]):
        mod["kernel"] = mod["kernel"] * 8.0
        mod["bias"] = mod["bias"] * 8.0
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel


def test_attention_rescore_matches_jax(peaked_pair):
    jmodel, variables, tmodel = peaked_pair
    xs, xlens, _, _ = ragged_batch(6)
    K = 4
    h_enc, enc_mask = jmodel.apply(variables, xs, xlens, method=jmodel.encode)
    logp = jax.nn.log_softmax(
        jmodel.apply(variables, h_enc, method=jmodel.ctc_logits), axis=-1)
    enc_lens = jmodel.get_pred_len(jnp.asarray(xlens))
    pre, plen, score = jdecode.ctc_prefix_beam_search(logp, enc_lens, beam_size=K)
    j_hyp, j_len = jdecode.attention_rescore(
        jmodel, variables, h_enc, enc_mask, pre, plen, score)
    with torch.no_grad():
        hyp, hlen = tdecode.attention_rescore(
            tmodel, t(h_enc), t(enc_mask), t(pre).long(), t(plen).long(), t(score))
    np.testing.assert_array_equal(hlen.numpy(), np.asarray(j_len))
    for b in range(xs.shape[0]):
        assert hyp[b, :hlen[b]].tolist() == np.asarray(j_hyp)[b, :j_len[b]].tolist()


@pytest.mark.parametrize(
    "mode", ["ctc_greedy", "ctc_prefix_beam_search", "attention_rescore"])
def test_decode_batch_matches_jax(peaked_pair, mode):
    jmodel, variables, tmodel = peaked_pair
    xs, xlens, _, _ = ragged_batch(7)
    ref = jdecode.decode_batch(jmodel, variables, jnp.asarray(xs),
                               jnp.asarray(xlens), beam_size=4, mode=mode)
    hyps = tdecode.decode_batch(tmodel, t(xs), t(xlens), beam_size=4, mode=mode)
    assert hyps == ref


def test_decode_batch_raises_on_unported_mode(peaked_pair):
    _, _, tmodel = peaked_pair
    xs, xlens, _, _ = ragged_batch(7)
    with pytest.raises(NotImplementedError):
        tdecode.decode_batch(tmodel, t(xs), t(xlens), mode="transducer_greedy")
