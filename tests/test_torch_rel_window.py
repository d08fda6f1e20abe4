"""The window formulation of the rel-pos term that the tensor-core bodies of
``csrc/rel_attention_fwd.cu`` and ``csrc/rel_attention_bwd.cu`` compute,
emulated tile by tile in plain PyTorch (fp32, CPU).

For a (query tile q0, key tile k0) pair of 64 x 64, window slot w (0..127)
holds diagonal delta = q0 - k0 - 63 + w and table row ``window_row``; the
kernels form B = q_v[q0 .. q0+64] . window^T (65 rows: the last is the
crossover q_v row) and read score (r, c) at slot w = 63 + r - c, from B's
row r (delta >= 0) or row r + 1 (delta <= -2). The backward scatters dS
into a window matrix dB (dS[r][c] at (r, w) for delta >= 0, at (r + 1, w)
for delta <= -2), then dQ_v = dB . window and dP_window = dB^T . q_v. These
tests hold that index arithmetic against the plain versions and
``rel_shift`` / ``rel_shift_adjoint`` at lengths around the tile edges.
"""

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.ops import flash_attention as fa

BM = BN = 64
SLOTS = 128
TOL = 1e-5
D = 32


def window_rows(dbase: int, t: int) -> torch.Tensor:
    """Table row of each window slot, -1 where the slot reads nothing (the
    kernels' ``tc::window_row``)."""
    w = torch.arange(SLOTS)
    delta = dbase + w
    row = torch.where(delta >= 0, t - 1 - delta, -delta - 2)
    ok = (w < SLOTS - 1) & (delta != -1) & (row >= 0) & (row < t)
    return torch.where(ok, row, -1)


def window(p: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(128, D) rows of the table, zero where ``rows`` is -1."""
    return torch.where((rows >= 0)[:, None], p[rows.clamp(min=0)], 0.0)


def tile_pairs(t: int):
    for q0 in range(0, t, BM):
        for k0 in range(0, t, BN):
            yield q0, k0, q0 - k0 - (BN - 1)


def local_slots(q0: int, k0: int, t: int):
    """Local (r, c) of the pair's valid scores, their slot and whether
    they read the next q_v row."""
    r = torch.arange(BM)[:, None].expand(BM, BN)
    c = torch.arange(BN)[None, :].expand(BM, BN)
    valid = (q0 + r < t) & (k0 + c < t)
    w = BN - 1 + r - c
    delta = q0 - k0 + r - c
    return r[valid], c[valid], w[valid], delta[valid]


def rel_scores_by_window(qv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """relshift(q_v P^T) for one row, (T, T), from 65 x 128 windows."""
    t = qv.shape[0]
    qv_pad = torch.cat([qv, qv.new_zeros(BM + 1, qv.shape[1])])
    out = qv.new_zeros(t, t)
    for q0, k0, dbase in tile_pairs(t):
        b = qv_pad[q0:q0 + BM + 1] @ window(p, window_rows(dbase, t)).T  # (65, 128)
        r, c, w, delta = local_slots(q0, k0, t)
        val = torch.where(delta >= 0, b[r, w],
                          torch.where(delta <= -2, b[(r + 1).clamp(max=BM), w], 0.0))
        out[q0 + r, k0 + c] = val
    return out


def rel_grads_by_window(ds: torch.Tensor, qv: torch.Tensor, p: torch.Tensor):
    """(dQ_v, dP) of one row from dS through dB windows (65 x 128)."""
    t = ds.shape[0]
    qv_pad = torch.cat([qv, qv.new_zeros(BM + 1, qv.shape[1])])
    dqv = qv.new_zeros(t + BM + 1, qv.shape[1])
    dp = p.new_zeros(p.shape)
    for q0, k0, dbase in tile_pairs(t):
        rows = window_rows(dbase, t)
        db = ds.new_zeros(BM + 1, SLOTS)
        r, c, w, delta = local_slots(q0, k0, t)
        dsv = ds[q0 + r, k0 + c]
        hi = delta >= 0
        lo = delta <= -2
        db[r[hi], w[hi]] = dsv[hi]
        db[r[lo] + 1, w[lo]] = dsv[lo]  # the score that read q_v row r + 1
        dqv[q0:q0 + BM + 1] += db @ window(p, rows)
        dpw = db.T @ qv_pad[q0:q0 + BM + 1]  # (128, D)
        keep = rows >= 0
        dp.index_add_(0, rows[keep], dpw[keep])
    return dqv[:t], dp


def _inputs(t: int, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.5).astype(np.float32))

    kv = torch.tensor([t, max(t - 37, 1)], dtype=torch.int32)
    return dict(q_u=mk(2, t, D), qv=mk(2, t, D), k=mk(2, t, D), v=mk(2, t, D),
                p=mk(1, t, D), kv_lens=kv, dout=mk(2, t, D))


LENGTHS = [48, 64, 65, 128, 199, 200]


@pytest.mark.parametrize("t", LENGTHS)
def test_window_scores_equal_rel_shift(t):
    x = _inputs(t)
    for b in range(2):
        ref = fa.rel_shift(x["qv"][b] @ x["p"][0].T)
        got = rel_scores_by_window(x["qv"][b], x["p"][0])
        torch.testing.assert_close(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("t", LENGTHS)
def test_window_forward_equals_plain(t):
    x = _inputs(t, 1)
    scale = D ** -0.5
    ref, ref_lse = fa.flash_attention_plain(
        x["q_u"], x["k"], x["v"], kv_lens=x["kv_lens"], rel_qv=x["qv"],
        rel_p=x["p"], scale=scale, return_lse=True)
    for b in range(2):
        s = (x["q_u"][b] @ x["k"][b].T + rel_scores_by_window(x["qv"][b], x["p"][0])) * scale
        s[:, int(x["kv_lens"][b]):] = fa.NEG_INF
        torch.testing.assert_close(torch.logsumexp(s, -1), ref_lse[b], rtol=0, atol=TOL)
        torch.testing.assert_close(torch.softmax(s, -1) @ x["v"][b], ref[b], rtol=0, atol=TOL)


@pytest.mark.parametrize("t", LENGTHS)
def test_window_adjoint_equals_rel_shift_adjoint(t):
    x = _inputs(t, 2)
    ds = torch.from_numpy((np.random.default_rng(3).normal(size=(t, t)) * 0.1).astype(np.float32))
    dqv, dp = rel_grads_by_window(ds, x["qv"][0], x["p"][0])
    dr = fa.rel_shift_adjoint(ds)
    torch.testing.assert_close(dqv, dr @ x["p"][0], rtol=0, atol=TOL)
    torch.testing.assert_close(dp, dr.T @ x["qv"][0], rtol=0, atol=TOL)


@pytest.mark.parametrize("t", LENGTHS)
def test_window_backward_equals_plain(t):
    """dQ_v and dP from dB windows equal K2's plain version; dS by the
    closed form of ``_bwd_kernel`` (no dropout)."""
    x = _inputs(t, 4)
    scale = D ** -0.5
    out, lse = fa.flash_attention_plain(
        x["q_u"], x["k"], x["v"], kv_lens=x["kv_lens"], rel_qv=x["qv"],
        rel_p=x["p"], scale=scale, return_lse=True)
    ref = fa.flash_rel_attention_bwd_plain(
        x["q_u"], x["qv"], x["k"], x["v"], x["p"], x["kv_lens"], out, lse,
        x["dout"], scale)
    dp_sum = torch.zeros_like(x["p"][0])
    for b in range(2):
        s = (x["q_u"][b] @ x["k"][b].T + rel_scores_by_window(x["qv"][b], x["p"][0])) * scale
        a = torch.exp(s - lse[b][:, None])
        a[:, int(x["kv_lens"][b]):] = 0.0
        dvec = (x["dout"][b] * out[b]).sum(-1, keepdim=True)
        ds = a * (x["dout"][b] @ x["v"][b].T - dvec) * scale
        dqv, dp = rel_grads_by_window(ds, x["qv"][b], x["p"][0])
        torch.testing.assert_close(dqv, ref[1][b], rtol=0, atol=TOL)
        dp_sum += dp
    torch.testing.assert_close(dp_sum, ref[4][0], rtol=0, atol=TOL)
