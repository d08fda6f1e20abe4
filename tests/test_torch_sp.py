"""Sequence parallelism on the port (``parallel.sharding``), on the CPU over
gloo, against one process and against the JAX package.

* K1/K1'/K2's plain versions on a block of the queries (``Shard.q0`` of
  ``t_q``, q_v with the next block's first row) give the whole call's rows
  at an odd T, with and without a chunk width (fp32, 1e-6), the halo row's
  dQ_v included; ``dropout_keep_global`` there is the whole mask's rows,
  bit for bit.
* The time split (the first T mod sp blocks one frame longer) and the
  depthwise conv's halo, which may span several neighbours.
* One update of a tiny conformer U2 (BatchNorm, accum 2, clip 1, dropout
  0) at sp = 2 with T' = 13 (blocks of 7 and 6 frames, shorter than the
  conv's 7-frame halo) against one process: the loss, every gradient, the
  BatchNorm statistics and the updated parameters within rtol 1e-4, atol
  1e-6.
* The train CLI at sp = 2 against the JAX package's dp = 4 x sp = 2 run
  (tests/test_tensor_parallel.py's configuration) on its 8 CPU devices:
  the mean loss and the parameters after one epoch within rtol 2e-4, atol
  2e-4.

Every subprocess runs under a hard 180 s limit (torch_dp_worker.launch).
"""

import numpy as np
import pytest
import torch

import torch_dp_worker as w
from liteasr_tpu_torch.ops import flash_attention as fa
from liteasr_tpu_torch.parallel import sharding
from test_torch_tp import (  # noqa: F401  (the fixtures)
    _attn_inputs, _ranks, _restore_prng_impl, check_against_jax, check_step,
    jax_against_port, one_process)


@pytest.mark.parametrize("chunk", [0, 5])
@pytest.mark.parametrize("q0,q1", [(0, 12), (12, 23), (4, 9)])
def test_plain_kernels_on_a_query_block(chunk, q0, q1):
    B, H, T, D, rate, seed = 2, 2, 23, 8, 0.2, -31
    x = _attn_inputs(B, H, T, D, seed=1)
    shard = fa.Shard(q0=q0, t_q=T)
    q1v = q1 + 1 if q1 < T else q1

    def run(x, shard):
        out, lse = fa.flash_attention_plain(
            x["q_u"], x["k"], x["v"], kv_lens=x["kv_lens"], rel_qv=x["qv"], rel_p=x["p"],
            scale=0.35, return_lse=True, dropout_rate=rate, dropout_seed=seed, chunk=chunk,
            shard=shard)
        grads = fa.flash_rel_attention_bwd_plain(
            x["q_u"], x["qv"], x["k"], x["v"], x["p"], x["kv_lens"], out.float(), lse,
            x["dout"], 0.35, rate, seed, chunk, shard)
        return out, lse, grads

    full = run(x, fa.WHOLE)
    dout = torch.zeros_like(x["dout"])  # the whole call's cotangent of the block's rows
    dout[:, q0:q1] = x["dout"][:, q0:q1]
    g_full = run(dict(x, dout=dout), fa.WHOLE)[2]
    block = dict(x, q_u=x["q_u"][:, q0:q1], qv=x["qv"][:, q0:q1v], dout=x["dout"][:, q0:q1])
    got = run(block, shard)
    torch.testing.assert_close(got[0], full[0][:, q0:q1], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], full[1][:, q0:q1], rtol=0, atol=1e-6)
    want = (g_full[0][:, q0:q1], g_full[1][:, q0:q1v], g_full[2], g_full[3], g_full[4])
    for name, g, r in zip(("dq_u", "dqv", "dk", "dv", "dp"), got[2], want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6, msg=name)
    if q1 < T and not chunk:  # the halo row's gradient is the next block's to take
        assert got[2][1][:, -1].abs().max() > 0
    keep = fa.dropout_keep_global(B * H, q1 - q0, T, seed, rate, shard=shard)
    assert torch.equal(keep, fa.dropout_keep_global(B * H, T, T, seed, rate)[:, q0:q1])
    with pytest.raises(ValueError, match="q_v rows"):
        fa.flash_attention_plain(block["q_u"], x["k"], x["v"], rel_qv=block["qv"][:, :1],
                                 rel_p=x["p"], shard=shard)


def test_time_split_and_halo():
    assert sharding.split_sizes(199, 2) == (100, 99)
    assert sharding.split_sizes(13, 4) == (4, 3, 3, 3)
    seqs = [sharding.SeqShard((4, 3, 3, 3), i) for i in range(4)]
    assert [(s.lo, s.hi) for s in seqs] == [(0, 4), (4, 7), (7, 10), (10, 13)]
    x = torch.randn(2, 13, 5)
    pad = 5  # wider than a block: a halo spans two neighbours

    def halo(i):  # sp_halo without a group: the gathered edges by hand
        edges = []
        for s in seqs:
            blk = x[:, s.lo:s.hi]
            e = min(pad, blk.shape[1])
            z = blk.new_zeros(2, pad - e, 5)
            edges.append(torch.cat([blk[:, :e], z, z, blk[:, blk.shape[1] - e:]], 1))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sharding, "gather_from_sp", lambda t, d, sizes: torch.cat(edges, 1))
            return sharding.sp_halo(x[:, seqs[i].lo:seqs[i].hi], pad, seqs[i])

    padded = torch.nn.functional.pad(x, (0, 0, pad, pad))
    for i, s in enumerate(seqs):
        assert torch.equal(halo(i), padded[:, s.lo:s.hi + 2 * pad]), i


def test_sp_step_equals_one_process(tmp_path, one_process):
    ranks = _ranks(tmp_path, 2, 2, 1)
    assert [(r["layout"].sp, r["layout"].sp_i) for r in ranks] == [(2, 0), (2, 1)]
    check_step(ranks, one_process)
    counts = ranks[0]["counts"]
    assert counts["gather@sp"] > 0 and counts["gather_grad@sp"] > 0 and counts["grad"] == 1
    assert "activation@tp" not in counts
    # each sp rank ran the tail on its own rows, and the encoder on its frames
    assert ranks[0]["dropout_h_enc"].shape[1] == 7 and ranks[1]["dropout_h_enc"].shape[1] == 6
    assert ranks[0]["dropout_h_ctc"].shape[0] + ranks[1]["dropout_h_ctc"].shape[0] == w.B


def test_sp_train_cli_matches_the_jax_sp_run(tiny_corpus, tmp_path):
    trainer, ckpt, losses = jax_against_port(tiny_corpus, tmp_path, sp=2, tp=1)
    # the sp ranks' losses are shares of the global batch's
    check_against_jax(trainer, ckpt, np.mean(np.sum(losses, axis=0)))
