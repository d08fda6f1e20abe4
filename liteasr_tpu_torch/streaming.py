"""Chunk-by-chunk streaming inference for chunk-trained U2 encoders
(liteasr_tpu/streaming.py).

The stream state holds fixed-capacity buffers, all allocated up front: the
per-layer K/V caches, written in place at the stream position, and either
the CTC greedy carry (the previous frame's id and a hypothesis buffer) or
the CTC prefix-beam carry of :func:`decode.ctc_prefix_beam_search`, carried
across chunks. Every step has the same shapes, so one step could be
captured as a CUDA graph.

Geometry: the conv front end (two stride-2 VALID convolutions, receptive
field 7, stride 4) is streamed by feeding overlapping raw windows
``raw[t*C : t*C + C + 4]`` with ``C = 4*chunk_sub``: every window emits
exactly ``chunk_sub`` new subsampled frames. With a positional table of
length ``pe_len`` equal to the offline padded T', the chunked rel-pos
attention (``RelativeMultiHeadAttention.chunk_step``) reproduces the
offline ``rel_shift``, the legacy wrap for in-chunk lookahead included, so
the stream's hidden states equal the offline chunked encoder's.
"""

import math
from typing import Optional

import torch

from liteasr_tpu_torch.decode import (
    _ctc_prefix_step, ctc_prefix_beam_finalize, ctc_prefix_beam_init)
from liteasr_tpu_torch.nets.subsampling import subsampled_length

MODES = ("ctc_greedy", "ctc_prefix_beam_search")


def init_stream_state(model, B: int, chunk_sub: int, n_chunks: int,
                      mode: str = "ctc_greedy", beam_size: int = 10,
                      device=None) -> dict:
    """Fresh stream state for ``B`` parallel utterances: capacity
    ``L = n_chunks * chunk_sub`` subsampled frames. The greedy hypothesis
    buffer has one spare column, where the frames that emit nothing write."""
    enc = model.encoder
    L = n_chunks * chunk_sub
    Dk = enc.h_dim // enc.n_head
    kw = dict(dtype=enc.compute_dtype, device=device)
    caches = [(torch.zeros((B, L, enc.n_head, Dk), **kw),
               torch.zeros((B, L, enc.n_head, Dk), **kw))
              for _ in range(enc.n_layer)]
    state = {"caches": caches, "index": 0}
    if mode == "ctc_prefix_beam_search":
        state["beam"] = ctc_prefix_beam_init(B, beam_size, L, device)
    else:
        state["prev"] = torch.full((B,), -1, dtype=torch.int64, device=device)
        state["hyp"] = torch.zeros((B, L + 1), dtype=torch.int64, device=device)
        state["hyp_len"] = torch.zeros((B,), dtype=torch.int64, device=device)
    return state


def _greedy_update(state: dict, ids: torch.Tensor, valid: torch.Tensor,
                   blank: int) -> None:
    """CTC greedy over one chunk's frame ids (B, c), in place: a frame
    emits its id unless it is blank, repeats the previous frame's or lies
    past the utterance."""
    hyp = state["hyp"]
    prev_frames = torch.cat([state["prev"][:, None], ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev_frames) & valid
    pos = state["hyp_len"][:, None] + torch.cumsum(keep, dim=1) - 1
    pos = torch.where(keep, pos, hyp.shape[1] - 1)  # the spare column
    hyp.scatter_(1, pos, ids)
    state["hyp_len"] += keep.sum(dim=1)
    state["prev"] = torch.where(valid[:, -1], ids[:, -1], state["prev"])


def stream_step(model, state: dict, window: torch.Tensor, sub_xlens: torch.Tensor,
                key_lens: torch.Tensor, pe_len: int, mode: str = "ctc_greedy",
                beam_size: int = 10, blank: int = 0) -> torch.Tensor:
    """One chunk: ``window`` (B, C + 4, F) raw frames emit ``chunk_sub`` new
    frames. ``key_lens`` (valid KEYS, the offline mask's ceil(xlen / 4))
    differs from ``sub_xlens`` (EMITTED frames, ((xlen-1)//2-1)//2): the last
    key can straddle the padding boundary and is unmasked offline. Returns
    the chunk's hidden states."""
    index = state["index"]
    c_sub = subsampled_length(window.shape[1])
    kv_lens = torch.clamp(key_lens, max=index + c_sub)
    h, logits = model.encode_chunk(window, state["caches"], index, kv_lens, pe_len)
    frames = index + torch.arange(c_sub, device=window.device)
    if mode == "ctc_prefix_beam_search":
        logp = torch.log_softmax(logits.float(), dim=-1)
        beam = state["beam"]
        max_len = beam[0].shape[-1]
        for i in range(c_sub):
            beam = _ctc_prefix_step(beam, logp[:, i], frames[i] < sub_xlens,
                                    beam_size, blank, max_len)
        state["beam"] = beam
    else:
        ids = torch.argmax(logits, dim=-1)
        _greedy_update(state, ids, frames[None, :] < sub_xlens[:, None], blank)
    state["index"] = index + c_sub
    return h


@torch.inference_mode()
def streaming_decode(model, xs: torch.Tensor, xlens, chunk_sub: int = 16,
                     mode: str = "ctc_greedy", beam_size: int = 10,
                     blank: int = 0, n_chunks: Optional[int] = None,
                     collect_enc: bool = False):
    """Decode a batch chunk by chunk; returns hypotheses like
    ``decode.decode_batch`` (a list of token-id lists).

    :param xs: (B, T, F) features on the model's device; ``xlens`` (B,)
    :param chunk_sub: emitted subsampled frames per step; a multiple of the
        model's ``static_chunk_size``, so that a frame's in-chunk lookahead
        never outruns the cache
    :param n_chunks: stream capacity (default: just covering ``xs``). The
        positional table's length, and through the legacy rel-shift the
        rel-pos attention's values, is tied to it: offline parity holds for
        an offline input padded to ``4 * n_chunks * chunk_sub + 4`` frames
    :param collect_enc: also return the (B, L, D) stream hidden states
    """
    if mode not in MODES:
        raise ValueError(f"unknown streaming mode {mode!r}; one of {MODES}")
    cs = model.encoder.static_chunk_size
    if chunk_sub < 1 or (cs > 0 and chunk_sub % cs):
        raise ValueError(f"chunk_sub {chunk_sub} must be a positive multiple of "
                         f"the model's static_chunk_size {cs}")
    B, T, _ = xs.shape
    C = 4 * chunk_sub
    if n_chunks is None:
        n_chunks = max(1, math.ceil(max(T - 4, 1) / C))
    T_pad = n_chunks * C + 4
    if T_pad > T:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, T_pad - T))
    L = n_chunks * chunk_sub
    xlens = torch.as_tensor(xlens, device=xs.device).long()
    sub_xlens = torch.clamp(((xlens - 1) // 2 - 1) // 2, max=L)
    key_lens = torch.clamp((xlens + 3) // 4, max=L)

    state = init_stream_state(model, B, chunk_sub, n_chunks, mode, beam_size,
                              xs.device)
    enc_chunks = []
    for t in range(n_chunks):
        h = stream_step(model, state, xs[:, t * C: t * C + C + 4], sub_xlens,
                        key_lens, L, mode, beam_size, blank)
        if collect_enc:
            enc_chunks.append(h)

    if mode == "ctc_prefix_beam_search":
        prefixes, plens, _ = ctc_prefix_beam_finalize(state["beam"])
        best, lens = prefixes[:, 0].cpu(), plens[:, 0].cpu()
    else:
        best, lens = state["hyp"].cpu(), state["hyp_len"].cpu()
    hyps = [best[b, : int(lens[b])].tolist() for b in range(B)]
    if collect_enc:
        return hyps, torch.cat(enc_chunks, dim=1)
    return hyps
