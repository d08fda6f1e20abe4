"""Decoding (liteasr_tpu/decode.py). U2: CTC greedy, CTC prefix beam
search, attention rescoring and attention beam search. Transducer: greedy,
the batched beam search and the host beam of reference semantics for one
utterance. Paraformer: CIF + argmax, one non-autoregressive pass.

The reference runs these as jitted ``lax.scan``/``vmap`` programs. Here
they run eagerly under ``torch.inference_mode()``: a Python loop over
frames (or output positions) in place of the scan, a batch dimension in
place of the vmap. The prefix beam keeps the reference's dense (B, K, Lmax)
hypotheses and its pair of 32-bit rolling hashes (emulated in int64, masked
to 32 bits), so both packages merge and rank the same candidates.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from liteasr_tpu_torch.ops.masks import padding_mask, triangle_mask

NEG_INF = -1e30
U32 = 0xFFFFFFFF
_H1_MULT = 1000003
_H2_MULT = 69069


def _hash_extend(h1, h2, tok):
    t = tok + 1
    return (h1 * _H1_MULT + t) & U32, (h2 * _H2_MULT + t) & U32


def _top_k(x, k: int):
    """``lax.top_k``: the k largest along the last axis, lower index first
    on ties (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _segment_logsumexp(scores, seg_ids):
    """Batched ``_segment_logsumexp`` of the reference over (B, N)."""
    seg_max = torch.full_like(scores, float("-inf")).scatter_reduce(
        1, seg_ids, scores, "amax")
    seg_max = torch.where(seg_max <= NEG_INF, 0.0, seg_max)
    shifted = torch.exp(scores - seg_max.gather(1, seg_ids))
    shifted = torch.where(scores <= NEG_INF, 0.0, shifted)
    seg_sum = torch.zeros_like(scores).scatter_add(1, seg_ids, shifted)
    out = seg_max + torch.log(torch.clamp(seg_sum, min=1e-38))
    return torch.where(seg_sum <= 0.0, NEG_INF, out)


def _ctc_prefix_step(state, logp_t, active, beam_size: int, blank: int,
                     max_len: int):
    """One frame of prefix beam search for a batch (liteasr_tpu/decode.py:
    60-154)."""
    prefixes, plens, last, h1, h2, pb, pnb = state
    B, K = pb.shape
    P = beam_size
    dev = pb.device
    ps, toks = _top_k(logp_t, P)  # (B, P)

    # stay candidates (K): prefix unchanged
    blank_in = toks == blank
    ps_blank = torch.where(blank_in, ps, NEG_INF).amax(dim=1, keepdim=True)
    stay_pb = torch.logaddexp(pb + ps_blank, pnb + ps_blank)
    rep_in = toks[:, None, :] == last[:, :, None]  # (B, K, P)
    ps_rep = torch.where(rep_in, ps[:, None, :], NEG_INF).amax(dim=2)
    stay_pnb = pnb + ps_rep

    # extend candidates (K, P): prefix + tok
    from_b = pb[:, :, None] + ps[:, None, :]
    ext_pnb = torch.where(
        rep_in, from_b, torch.logaddexp(from_b, pnb[:, :, None] + ps[:, None, :]))
    ext_pnb = torch.where(blank_in[:, None, :], NEG_INF, ext_pnb)
    ext_pnb = torch.where(plens[:, :, None] >= max_len, NEG_INF, ext_pnb)
    toks_kp = toks[:, None, :].expand(B, K, P)
    eh1, eh2 = _hash_extend(h1[:, :, None], h2[:, :, None], toks_kp)
    # dead extend candidates must not hash-collide with anything real
    dead = ext_pnb <= NEG_INF
    salt = torch.arange(K * P, dtype=torch.int64, device=dev).reshape(K, P) + 0xA5A50000
    eh1 = torch.where(dead, salt, eh1)
    eh2 = torch.where(dead, (salt * _H2_MULT) & U32, eh2)

    # flatten candidates: N = K + K*P
    N = K + K * P
    cand_h1 = torch.cat([h1, eh1.reshape(B, -1)], dim=1)
    cand_h2 = torch.cat([h2, eh2.reshape(B, -1)], dim=1)
    cand_pb = torch.cat([stay_pb, torch.full((B, K * P), NEG_INF, device=dev)], dim=1)
    cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, -1)], dim=1)
    ar_k = torch.arange(K, device=dev)
    cand_parent = torch.cat([ar_k, ar_k.repeat_interleave(P)])  # (N,)
    cand_tok = torch.cat([torch.full((B, K), -1, dtype=toks.dtype, device=dev),
                          toks_kp.reshape(B, -1)], dim=1)

    # merge duplicates: lexsort by (h1, h2) as two stable sorts, then
    # segment-logsumexp
    o2 = torch.sort(cand_h2, dim=1, stable=True).indices
    o1 = torch.sort(cand_h1.gather(1, o2), dim=1, stable=True).indices
    order = o2.gather(1, o1)
    s_h1, s_h2 = cand_h1.gather(1, order), cand_h2.gather(1, order)
    s_pb, s_pnb = cand_pb.gather(1, order), cand_pnb.gather(1, order)
    is_first = torch.ones_like(s_h1, dtype=torch.bool)
    is_first[:, 1:] = (s_h1[:, 1:] != s_h1[:, :-1]) | (s_h2[:, 1:] != s_h2[:, :-1])
    seg_ids = torch.cumsum(is_first, dim=1) - 1  # (B, N)
    seg_pb = _segment_logsumexp(s_pb, seg_ids)
    seg_pnb = _segment_logsumexp(s_pnb, seg_ids)
    # representative candidate = first of each segment (index into sorted)
    ar_n = torch.arange(N, device=dev).expand(B, N)
    rep_idx = torch.full((B, N), N, device=dev).scatter_reduce(
        1, seg_ids, ar_n, "amin")
    seg_valid = torch.zeros((B, N), dtype=torch.int64, device=dev).scatter_add(
        1, seg_ids, torch.ones_like(seg_ids)) > 0

    seg_score = torch.where(seg_valid, torch.logaddexp(seg_pb, seg_pnb), NEG_INF)
    _, top_seg = _top_k(seg_score, K)

    sel_sorted = rep_idx.gather(1, top_seg)
    sel = order.gather(1, sel_sorted.clamp(0, N - 1))  # into raw candidates
    sel_parent = cand_parent[sel]  # (B, K)
    sel_tok = cand_tok.gather(1, sel)

    new_pb = seg_pb.gather(1, top_seg)
    new_pnb = seg_pnb.gather(1, top_seg)
    new_h1 = cand_h1.gather(1, sel)
    new_h2 = cand_h2.gather(1, sel)

    parent_prefix = prefixes.gather(1, sel_parent[:, :, None].expand(B, K, max_len))
    parent_len = plens.gather(1, sel_parent)
    parent_last = last.gather(1, sel_parent)
    is_ext = sel_tok >= 0
    pos = torch.arange(max_len, device=dev)[None, None, :]
    new_prefixes = torch.where(
        (pos == parent_len[:, :, None]) & is_ext[:, :, None],
        sel_tok[:, :, None], parent_prefix)
    new_plens = parent_len + is_ext.to(parent_len.dtype)
    new_last = torch.where(is_ext, sel_tok, parent_last)

    new_state = (new_prefixes, new_plens, new_last, new_h1, new_h2, new_pb, new_pnb)

    def keep(n, o):
        a = active.reshape((B,) + (1,) * (n.dim() - 1))
        return torch.where(a, n, o)

    return tuple(keep(n, o) for n, o in zip(new_state, state))


def ctc_prefix_beam_init(B: int, K: int, max_len: int, device=None):
    """Fresh prefix-beam state (liteasr_tpu/decode.py:188-203)."""
    prefixes = torch.zeros((B, K, max_len), dtype=torch.int64, device=device)
    plens = torch.zeros((B, K), dtype=torch.int64, device=device)
    last = torch.full((B, K), -1, dtype=torch.int64, device=device)
    h1 = ((torch.arange(K, dtype=torch.int64, device=device) + 0x5EED0001)
          * 2654435761) & U32
    h1 = h1[None, :].expand(B, K).clone()
    h2 = h1 ^ 0x9E3779B9
    # only beam 0 (the empty prefix) is live initially
    pb = torch.full((B, K), NEG_INF, device=device)
    pb[:, 0] = 0.0
    pnb = torch.full((B, K), NEG_INF, device=device)
    h1[:, 0] = 17
    h2[:, 0] = 29
    return (prefixes, plens, last, h1, h2, pb, pnb)


def ctc_prefix_beam_finalize(state):
    """Sort a prefix-beam state by total score, descending (stable)."""
    prefixes, plens, last, h1, h2, pb, pnb = state
    scores = torch.logaddexp(pb, pnb)
    order = torch.sort(-scores, dim=1, stable=True).indices
    return (prefixes.gather(1, order[:, :, None].expand_as(prefixes)),
            plens.gather(1, order), scores.gather(1, order))


def ctc_prefix_beam_search(ctc_logp: torch.Tensor, enc_lens: torch.Tensor,
                           beam_size: int = 10, blank: int = 0,
                           max_len: Optional[int] = None):
    """Batched prefix beam search over CTC posteriors.

    :param ctc_logp: (B, T', V) log-softmax CTC output
    :param enc_lens: (B,) valid frames
    :return: (prefixes (B, K, Lmax), lens (B, K), scores (B, K)) sorted by
        score, descending; Lmax = T' unless given.
    """
    B, T, V = ctc_logp.shape
    Lmax = max_len or T
    state = ctc_prefix_beam_init(B, beam_size, Lmax, ctc_logp.device)
    for t in range(T):
        state = _ctc_prefix_step(state, ctc_logp[:, t], t < enc_lens,
                                 beam_size, blank, Lmax)
    return ctc_prefix_beam_finalize(state)


def attention_rescore(model, h_enc, enc_mask, prefixes, plens, ctc_scores,
                      ctc_weight: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the best CTC n-best hypothesis by decoder log-prob plus
    ``ctc_weight`` times its CTC score (liteasr_tpu/decode.py:222-279).
    Returns (best hyp tokens (B, Lmax), best lens (B,))."""
    B, K, Lmax = prefixes.shape
    dev = prefixes.device
    flat = prefixes.reshape(B * K, Lmax)
    flens = plens.reshape(B * K)
    ys_in = torch.cat(
        [torch.full((B * K, 1), model.sos, dtype=flat.dtype, device=dev), flat], dim=1)
    mask = (padding_mask(flens + 1, Lmax + 1)[:, None, :]
            | triangle_mask(Lmax + 1, device=dev)[None])
    mem = h_enc.repeat_interleave(K, dim=0)  # (B*K, T', D)
    mem_mask = enc_mask.repeat_interleave(K, dim=0)

    logits = model.decode_logits(ys_in, mem, mask, mem_mask)  # (BK, L+1, V)
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    # sum_j logp[j, y_j] over the hypothesis + logp[len, eos]
    tok_logp = logp[:, :Lmax].gather(2, flat[:, :, None])[:, :, 0]
    pos = torch.arange(Lmax, device=dev)[None, :]
    att_score = torch.where(pos < flens[:, None], tok_logp, 0.0).sum(dim=1)
    att_score = att_score + logp[torch.arange(B * K, device=dev), flens, model.eos]
    del logp

    total = att_score.reshape(B, K) + ctc_weight * ctc_scores
    # dead beams (score=-inf) must never win
    total = torch.where(ctc_scores <= NEG_INF / 2, float("-inf"), total)
    best = torch.argmax(total, dim=1)
    best_hyp = prefixes.gather(1, best[:, None, None].expand(B, 1, Lmax))[:, 0]
    return best_hyp, plens.gather(1, best[:, None])[:, 0]


def attention_beam_search(model, h_enc, enc_mask, beam_size: int = 10,
                          max_decode_len: Optional[int] = None,
                          use_cache: bool = True, early_stop: bool = True):
    """Batched attention beam search (liteasr_tpu/decode.py:286-406).

    ``use_cache`` (default) primes every decoder layer's source K/V once
    and carries a self-attention K/V cache of (B*K, L+1, H, Dk) per layer,
    written in place at each step and re-gathered along with the beams; the
    recompute path runs the whole decoder over the (B*K, L+1) prefixes at
    every step (through K1 on the card). L = ``max_decode_len`` or the
    padded T' of ``h_enc``. A finished beam's only candidate is (eos, +0);
    top-k puts the lower index first on ties, as ``lax.top_k`` does. With
    ``early_stop`` the loop stops once every beam has finished: later steps
    would only append eos at +0 and keep the order of the finite scores
    (without it, all L steps run, as in a program of static shapes).

    Returns (tokens (B, L) without sos, lens (B,) = position of the first
    eos, scores (B,) of the best beams)."""
    B, T, _ = h_enc.shape
    K = beam_size
    L = max_decode_len or T
    sos, eos = model.sos, model.eos
    dev = h_enc.device

    hyps = torch.full((B, K, L + 1), eos, dtype=torch.int64, device=dev)
    hyps[:, :, 0] = sos
    scores = torch.full((B, K), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    end_flag = torch.zeros((B, K), dtype=torch.bool, device=dev)
    init_scores = torch.full((K,), float("-inf"), device=dev)
    init_scores[0] = 0.0
    mem = h_enc.repeat_interleave(K, dim=0)
    mem_mask = enc_mask.repeat_interleave(K, dim=0)
    # beam k of batch row b is row b*K + k of every (B*K, ...) tensor
    row0 = (torch.arange(B, device=dev) * K)[:, None]

    def merge(hyps, scores, end_flag, logp_i, i):
        score_topk, index_topk = _top_k(logp_i, K)  # (B*K, K)
        score_topk = score_topk.reshape(B, K, K)
        index_topk = index_topk.reshape(B, K, K)
        score_topk = torch.where(end_flag[:, :, None], init_scores, score_topk)
        index_topk = torch.where(end_flag[:, :, None], eos, index_topk)
        comb = (scores[:, :, None] + score_topk).reshape(B, K * K)
        new_scores, idx = _top_k(comb, K)
        src_beam = idx // K
        new_tok = index_topk.reshape(B, K * K).gather(1, idx)
        new_hyps = hyps.gather(1, src_beam[:, :, None].expand(B, K, L + 1))
        new_hyps[:, :, i] = new_tok
        return new_hyps, new_scores, new_tok == eos, src_beam

    if use_cache:
        src_kv = model.decode_prime(mem)
        k0 = src_kv[0][0]
        caches = [tuple(torch.zeros((B * K, L + 1) + k0.shape[2:], dtype=k0.dtype,
                                    device=dev) for _ in range(2))
                  for _ in src_kv]
    else:
        causal = triangle_mask(L + 1, device=dev)[None]  # (1, L+1, L+1)

    for i in range(1, L + 1):
        if use_cache:
            tok = hyps[:, :, i - 1].reshape(B * K)
            logits = model.decode_step(tok, src_kv, caches, i - 1, mem_mask)
        else:
            logits = model.decode_logits(hyps.reshape(B * K, L + 1), mem, causal,
                                         mem_mask)[:, i - 1]
        logp_i = torch.log_softmax(logits.float(), dim=-1)
        hyps, scores, end_flag, src_beam = merge(hyps, scores, end_flag, logp_i, i)
        if use_cache:  # beam-reorder the cache rows along with the hyps
            rows = (src_beam + row0).reshape(B * K)
            caches = [(k.index_select(0, rows), v.index_select(0, rows))
                      for k, v in caches]
        if early_stop and i % 8 == 0 and bool(end_flag.all()):
            break

    best = torch.argmax(scores, dim=1)
    body = hyps.gather(1, best[:, None, None].expand(B, 1, L + 1))[:, 0, 1:]
    is_eos = body == eos
    lens = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1), L)
    return body, lens, scores.gather(1, best[:, None])[:, 0]


def ctc_greedy(ctc_logp: torch.Tensor, enc_lens: torch.Tensor, blank: int = 0):
    """Argmax collapse decode. Returns (tokens (B, T'), keep mask (B, T'))."""
    ids = torch.argmax(ctc_logp, dim=-1)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    keep = (ids != blank) & (ids != prev) & (pos < enc_lens[:, None])
    return ids, keep


DECODE_MODES = ("ctc_greedy", "ctc_prefix_beam_search", "attention_rescore", "attention")


def decode_pipeline(model, mode: str = "attention_rescore", beam_size: int = 10,
                    ctc_weight: float = 0.5, early_stop: bool = True):
    """The U2 decode of ``mode`` as one function of the padded batch,
    ``pipeline(xs, xlens)`` -> tensors (``_get_pipeline``,
    liteasr_tpu/decode.py:434-464): ``ctc_greedy`` (ids (B, T'), keep
    (B, T')), ``ctc_prefix_beam_search`` and ``attention_rescore`` (tokens
    (B, T'), lens (B,)), ``attention`` (tokens (B, T'), lens (B,), scores
    (B,)). It branches on no tensor's value when ``early_stop`` is off, so
    that ``export.py`` traces it whole; :func:`decode_batch` runs the same
    function and converts its tensors on the host."""
    if mode not in DECODE_MODES:
        raise NotImplementedError(f"decode mode {mode!r} is not ported")

    def pipeline(xs, xlens):
        h_enc, enc_mask = model.encode(xs, xlens)
        if mode == "attention":
            return attention_beam_search(model, h_enc, enc_mask, beam_size=beam_size,
                                         early_stop=early_stop)
        enc_lens = model.get_pred_len(xlens)
        ctc_logp = torch.log_softmax(model.ctc_logits(h_enc).float(), dim=-1)
        if mode == "ctc_greedy":
            return ctc_greedy(ctc_logp, enc_lens)
        prefixes, plens, scores = ctc_prefix_beam_search(
            ctc_logp, enc_lens, beam_size=beam_size)
        if mode == "ctc_prefix_beam_search":
            return prefixes[:, 0], plens[:, 0]
        return attention_rescore(model, h_enc, enc_mask, prefixes, plens, scores,
                                 ctc_weight=ctc_weight)

    return pipeline


def hypotheses(model, mode: str, out) -> List[List[int]]:
    """The token-id lists of a :func:`decode_pipeline` result, on the host."""
    if mode == "ctc_greedy":
        ids, keep = (t.cpu() for t in out)
        return [ids[b][keep[b]].tolist() for b in range(ids.shape[0])]
    hyp, lens = out[0].cpu(), out[1].cpu()
    hyps = [hyp[b, :int(lens[b])].tolist() for b in range(hyp.shape[0])]
    if mode == "attention":
        return [[t for t in h if t != model.eos] for h in hyps]
    return hyps


def decode_batch(model, xs, xlens, beam_size: int = 10,
                 ctc_weight: float = 0.5,
                 mode: str = "attention_rescore") -> List[List[int]]:
    """Decode a padded batch of utterances (on the model's device) through
    :func:`decode_pipeline`. Returns a list of token-id lists."""
    pipeline = decode_pipeline(model, mode, beam_size, ctc_weight)
    with torch.inference_mode():
        return hypotheses(model, mode, pipeline(xs, xlens))


def paraformer_decode(model, xs, xlens) -> List[List[int]]:
    """Paraformer: CIF + parallel decoder + argmax over a padded batch
    (liteasr_tpu/decode.py:467-482), ``u_max = max(get_pred_len(T), 1)`` of
    the padded length T. Returns the token lists cut at ``ulens``."""
    u_max = max(model.get_pred_len(xs.shape[1]), 1)
    with torch.no_grad():
        hyp, ulens = model.decode(xs, xlens, u_max)
    hyp, ulens = hyp.cpu(), ulens.cpu()
    return [hyp[b, :int(ulens[b])].tolist() for b in range(hyp.shape[0])]


def _one_utterance(model, x):
    """Features (T, F) or (1, T, F) -> (xs (1, T, F), xlens (1,)) on the
    model's device."""
    dev = next(model.parameters()).device
    xs = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    if xs.dim() == 2:
        xs = xs[None]
    return xs, torch.tensor([xs.shape[1]], device=dev)


def decode_utterance(model, x, mode: str = "attention_rescore",
                     beam_size: int = 10, ctc_weight: float = 0.5) -> List[int]:
    """Single-utterance decode (the trainer's inference helper, ad-hoc use),
    by model family: a transducer runs the batched beam search, a
    Paraformer CIF + argmax, U2 ``decode_batch`` in ``mode``
    (liteasr_tpu/decode.py:506-525)."""
    xs, xlens = _one_utterance(model, x)
    if hasattr(model, "joint"):
        return transducer_beam_search(model, xs, xlens, beam_size=beam_size)[0]
    if hasattr(model, "predictor"):  # Paraformer (unpadded: u_max from its length)
        return paraformer_decode(model, xs, xlens)[0]
    if not hasattr(model, "ctc_logits"):
        raise NotImplementedError(
            f"decoding {type(model).__name__}: not a model of the decoding families "
            "(U2, transducer, Paraformer)")
    return decode_batch(model, xs, xlens, beam_size=beam_size,
                        ctc_weight=ctc_weight, mode=mode)[0]


# --------------------------------------------------------------------------
# Transducer decoding
# --------------------------------------------------------------------------


def _where_rows(keep, new, old):
    """``torch.where`` of every leaf of a state (a list of (c, h)) by a
    per-row mask ``keep`` over its leading dims."""
    def pick(n, o):
        return torch.where(keep.reshape(keep.shape + (1,) * (n.dim() - keep.dim())), n, o)

    return [(pick(nc, oc), pick(nh, oh)) for (nc, nh), (oc, oh) in zip(new, old)]


def transducer_greedy_search(model, h_enc, enc_lens, max_symbols_per_frame: int = 3):
    """Batched greedy RNN-T decode over encoder output ``h_enc`` (B, T', D)
    (liteasr_tpu/decode.py:532-595): at each frame up to
    ``max_symbols_per_frame`` rounds; a round emits the argmax token unless it
    is blank, and the frame stops at its first blank. The prediction
    network's state advances only on emission. Returns (tokens (B, Lmax),
    lens (B,)); Lmax = T' * max_symbols_per_frame."""
    B, T, _ = h_enc.shape
    dev = h_enc.device
    Lmax = T * max_symbols_per_frame
    state = model.decoder_init_state(B, dev)
    last = torch.zeros((B,), dtype=torch.int64, device=dev)  # blank starts it
    buf = torch.zeros((B, Lmax), dtype=torch.int64, device=dev)
    length = torch.zeros((B,), dtype=torch.int64, device=dev)
    pos = torch.arange(Lmax, device=dev)[None, :]
    for t in range(T):
        h_t = h_enc[:, t]
        active = t < enc_lens
        for _ in range(max_symbols_per_frame):
            dec_out, new_state = model.decoder_step(last, state)
            tok = torch.argmax(model.joint(h_t, dec_out), dim=-1)
            emit = (tok != 0) & active & (length < Lmax)
            buf = torch.where((pos == length[:, None]) & emit[:, None], tok[:, None], buf)
            length = length + emit.long()
            last = torch.where(emit, tok, last)
            state = _where_rows(emit, new_state, state)
            active = active & emit  # the frame ends at its first blank
    return buf, length


def transducer_greedy(model, xs, xlens,
                      max_symbols_per_frame: int = 3) -> List[List[int]]:
    """Greedy decode of a padded batch; Lmax from the padded T' as in the
    reference. Returns a list of token-id lists."""
    with torch.inference_mode():
        h_enc, _ = model.encode(xs, xlens)
        buf, length = transducer_greedy_search(
            model, h_enc, model.get_pred_len(xlens), max_symbols_per_frame)
    buf, length = buf.cpu(), length.cpu()
    return [buf[b, :int(length[b])].tolist() for b in range(buf.shape[0])]


def _gather_beams(tree: dict, idx):
    """Gather every (B, K, ...) leaf of ``tree`` (the LSTM state a list of
    (c, h)) along the beam axis by ``idx`` (B, K)."""
    def g(x):
        i = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
        return x.gather(1, i.expand(idx.shape + x.shape[2:]))

    return {key: ([(g(c), g(h)) for c, h in val] if key == "lstm" else g(val))
            for key, val in tree.items()}


def transducer_beam(model, h_enc, enc_lens, beam_size: int = 10,
                    expansions_per_frame: int = 5):
    """Batched time-synchronous RNN-T beam search over ``h_enc`` (B, T', D)
    (liteasr_tpu/decode.py:661-803). Each frame runs up to E =
    ``expansions_per_frame`` emission rounds: every beam proposes its blank
    candidate, merged into a top-K finished set (2K -> K), and top-P
    non-blank extensions (P = min(K, V-1)), of which the global top-K advance
    the prediction network; one last blank round closes the frame. A beam at
    Lmax = T' * E tokens cannot emit; frames at t >= enc_len carry the
    incoming beams unchanged. The final pick normalizes each score by the
    length + 1 (the reference's yseq holds a leading blank). Every top-k puts
    the lower index first on ties, as ``lax.top_k`` does.

    Returns (tokens (B, Lmax), lens (B,), scores (B,)): the best beam of
    each row and its unnormalized score."""
    B, T, _ = h_enc.shape
    K = beam_size
    E = max(1, expansions_per_frame)
    Lmax = T * E
    dev = h_enc.device
    neg_inf = float("-inf")

    lstm0 = [(c.reshape(B, K, -1), h.reshape(B, K, -1))
             for c, h in model.decoder_init_state(B * K, dev)]
    scores0 = torch.full((B, K), neg_inf, device=dev)
    scores0[:, 0] = 0.0
    beams = {"tokens": torch.zeros((B, K, Lmax), dtype=torch.int64, device=dev),
             "lens": torch.zeros((B, K), dtype=torch.int64, device=dev),
             "last": torch.zeros((B, K), dtype=torch.int64, device=dev),
             "scores": scores0, "lstm": lstm0}
    pos = torch.arange(Lmax, device=dev)[None, None, :]

    for t in range(T):
        h_t = h_enc[:, t, None, :]  # (B, 1, D)
        fin = dict(beams, scores=torch.full((B, K), neg_inf, device=dev))
        cur = beams
        for e in range(E + 1):
            flat_lstm = [(c.reshape(B * K, -1), h.reshape(B * K, -1))
                         for c, h in cur["lstm"]]
            dec_out, new_flat = model.decoder_step(cur["last"].reshape(B * K), flat_lstm)
            new_lstm = [(c.reshape(B, K, -1), h.reshape(B, K, -1)) for c, h in new_flat]
            logits = model.joint(h_t, dec_out.reshape(B, K, -1))  # (B, K, V)
            logp = torch.log_softmax(logits.float(), dim=-1)

            # blank candidates -> the finished set (2K -> K)
            cand = dict(cur, scores=cur["scores"] + logp[:, :, 0])
            merged = {key: ([(torch.cat([fc, cc], 1), torch.cat([fh, ch], 1))
                             for (fc, fh), (cc, ch) in zip(fin["lstm"], cand["lstm"])]
                            if key == "lstm" else torch.cat([fin[key], cand[key]], 1))
                      for key in fin}
            top_sc, top_idx = _top_k(merged["scores"], K)
            fin = _gather_beams(merged, top_idx)
            fin["scores"] = top_sc
            if e == E:
                break

            # non-blank extensions: top-P tokens per beam -> global top-K
            nb = logp.clone()
            nb[:, :, 0] = neg_inf
            P = min(K, nb.shape[-1] - 1)  # the vocabulary may be tiny in tests
            tok_sc, tok_id = _top_k(nb, P)  # (B, K, P)
            comb = (cur["scores"][:, :, None] + tok_sc).reshape(B, K * P)
            new_sc, flat_idx = _top_k(comb, K)
            tok = tok_id.reshape(B, K * P).gather(1, flat_idx)
            nxt = _gather_beams({"tokens": cur["tokens"], "lens": cur["lens"],
                                 "last": cur["last"], "lstm": new_lstm},
                                flat_idx // P)
            can_emit = nxt["lens"] < Lmax
            nxt["tokens"] = torch.where(
                (pos == nxt["lens"][:, :, None]) & can_emit[:, :, None],
                tok[:, :, None], nxt["tokens"])
            nxt["lens"] = nxt["lens"] + can_emit.long()
            nxt["last"] = torch.where(can_emit, tok, nxt["last"])
            nxt["scores"] = torch.where(can_emit, new_sc, neg_inf)
            cur = nxt

        # frames past a row's length carry its incoming beams unchanged
        active = t < enc_lens  # (B,)
        beams = {key: (_where_rows(active, fin[key], beams[key]) if key == "lstm"
                       else torch.where(active.reshape((B,) + (1,) * (fin[key].dim() - 1)),
                                        fin[key], beams[key]))
                 for key in beams}

    norm = beams["scores"] / torch.clamp(beams["lens"] + 1, min=1).float()
    best = torch.argmax(norm, dim=1)
    rows = torch.arange(B, device=dev)
    return beams["tokens"][rows, best], beams["lens"][rows, best], beams["scores"][rows, best]


def transducer_beam_search(model, xs, xlens, beam_size: int = 10,
                           expansions_per_frame: int = 5) -> List[List[int]]:
    """The batched beam search of a padded batch (:func:`transducer_beam`).
    Returns a list of token-id lists."""
    with torch.inference_mode():
        h_enc, _ = model.encode(xs, xlens)
        tokens, lens, _ = transducer_beam(
            model, h_enc, model.get_pred_len(xlens), beam_size, expansions_per_frame)
    tokens, lens = tokens.cpu(), lens.cpu()
    return [tokens[b, :int(lens[b])].tolist() for b in range(tokens.shape[0])]


def transducer_beam_search_utt(model, x, beam_size: int = 10) -> List[int]:
    """Reference-semantics transducer beam search for one utterance
    (liteasr_tpu/decode.py:598-658): per frame, best-first expansion of the
    frontier until ``beam_size`` blank-ended hypotheses are kept (at most 100
    expansions), with a prediction-network cache keyed by the emitted
    prefix; the final pick is length-normalized. A host loop."""
    xs, xlens = _one_utterance(model, x)
    dev = xs.device
    with torch.inference_mode():
        h_enc, _ = model.encode(xs, xlens)
        T = int(model.get_pred_len(xlens)[0])
        hyps = [{"score": 0.0, "yseq": [0], "state": model.decoder_init_state(1, dev)}]
        for t in range(T):
            h_t = h_enc[:, t]  # (1, D)
            frontier, kept, cache, steps = hyps, [], {}, 0
            while len(kept) < beam_size and frontier and steps < 100:
                steps += 1
                best = max(frontier, key=lambda h: h["score"])
                frontier.remove(best)
                key = tuple(best["yseq"])
                if key not in cache:
                    tok = torch.tensor([best["yseq"][-1]], device=dev)
                    cache[key] = model.decoder_step(tok, best["state"])
                dec_out, new_state = cache[key]
                logp = torch.log_softmax(model.joint(h_t, dec_out).float(), dim=-1)
                logp = logp[0].cpu().numpy()
                for k in np.argsort(-logp)[:beam_size + 1]:
                    k = int(k)
                    cand = {"score": best["score"] + float(logp[k]),
                            "yseq": list(best["yseq"]), "state": best["state"]}
                    if k == 0:
                        kept.append(cand)
                    else:
                        cand["yseq"].append(k)
                        cand["state"] = new_state
                        frontier.append(cand)
            if not kept:  # expansion cap hit before any blank: keep the frontier
                kept = frontier if frontier else hyps
            hyps = sorted(kept, key=lambda h: h["score"], reverse=True)[:beam_size]
    best = max(hyps, key=lambda h: h["score"] / max(len(h["yseq"]), 1))
    return best["yseq"][1:]  # strip the leading blank
