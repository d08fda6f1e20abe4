"""K1, K1' and K2 at a head and query offset on the card (marker ``gpu``,
skipped without CUDA), without JAX, so the card runs it with ``python -m
pytest --noconftest -m gpu tests/test_torch_tp_sp_gpu.py``.

Tensor parallelism hands a kernel a slice of each batch row's heads
(``Shard.head0`` of ``h_total``), sequence parallelism a block of the
queries at ``q0`` with the next block's first q_v row. The Paraformer's
pass 1 under tp calls K1 (no rel-pos term, no dropout) on the rank's heads
of its decoder attentions. Each case holds the
CUDA kernels at the offsets against the plain versions at the same offsets
(fp32 1e-4 forward and 1e-3 gradients, bf16 2e-2 and 5e-2, relative to each
value, as chip_smoke.py's phases 3 and k), and the fp32 shard against the
rows and heads of the whole call on the card, the halo's dQ_v row included
(1e-4: K2 sums by atomics in any order). A kv_len = 0 row, dropout 0.1.
"""

import pytest
import torch

from liteasr_tpu_torch.ops import flash_attention as fa

B, H, T, D = 4, 4, 199, 64
RATE, SEED = 0.1, 1234
TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 5e-2)}
CASES = {  # name: (head0, heads, q0, q1, chunk)
    "tp_h0": (0, 2, 0, T, 0),
    "tp_h2": (2, 2, 0, T, 0),
    "sp_q0": (0, H, 0, 100, 0),
    "sp_q100": (0, H, 100, T, 0),
    "sp_q0_chunk16": (0, H, 0, 100, 16),
    "sp_q100_chunk16": (0, H, 100, T, 16),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, dtype):
    gen = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return (0.5 * torch.randn(*shape, generator=gen)).to(dev, dtype)

    kv = torch.tensor([T, 150, 0, 77], dtype=torch.int32).repeat_interleave(H)
    return dict(q_u=rnd(B * H, T, D), qv=rnd(B * H, T, D), k=rnd(B * H, T, D),
                v=rnd(B * H, T, D), p=rnd(H, T, D), kv_lens=kv.to(dev),
                dout=torch.randn(B * H, T, D, generator=gen).to(dev))


def _cut(x, head0, heads, q0, q1):
    """The shard's inputs: heads head0.. of every batch row, queries q0:q1
    (q_v with the next block's first row)."""
    rows = torch.tensor([b * H + h for b in range(B) for h in range(head0, head0 + heads)],
                        device=x["q_u"].device)
    q1v = q1 + (q1 < T)
    out = {n: x[n][rows] for n in ("q_u", "qv", "k", "v", "kv_lens", "dout")}
    for n in ("q_u", "dout"):
        out[n] = out[n][:, q0:q1].contiguous()
    out["qv"] = out["qv"][:, q0:q1v].contiguous()
    out["p"] = x["p"][head0:head0 + heads].contiguous()
    return out, rows


def _run(x, chunk, shard, plain=False):
    """(out, lse, grads) of K1' then K2 on ``x``."""
    f = fa.flash_attention_plain if plain else fa.flash_attention
    b = fa.flash_rel_attention_bwd_plain if plain else fa.flash_rel_attention_bwd
    out, lse = f(x["q_u"], x["k"], x["v"], kv_lens=x["kv_lens"], rel_qv=x["qv"],
                 rel_p=x["p"], scale=D ** -0.5, return_lse=True, dropout_rate=RATE,
                 dropout_seed=SEED, chunk=chunk, shard=shard)
    grads = b(x["q_u"], x["qv"], x["k"], x["v"], x["p"], x["kv_lens"], out.float(), lse,
              x["dout"], D ** -0.5, RATE, SEED, chunk, shard)
    return out.float(), lse, grads


def _close(got, ref, tol):
    return bool(((got.float() - ref.float()).abs() <= tol + tol * ref.float().abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_at_offsets_match_plain(cuda, dtype, case):
    head0, heads, q0, q1, chunk = CASES[case]
    x, _ = _cut(_inputs(cuda, dtype), head0, heads, q0, q1)
    shard = fa.Shard(q0=q0, t_q=T, head0=head0, h_local=heads, h_total=H)
    out, lse, grads = _run(x, chunk, shard)
    ref_out, ref_lse, ref_grads = _run(x, chunk, shard, plain=True)
    ftol, gtol = TOL[dtype]
    live = x["kv_lens"] > 0
    assert _close(out, ref_out, ftol)
    assert _close(lse[live], ref_lse[live], ftol)
    for name, g, r in zip(("dq_u", "dqv", "dk", "dv", "dp"), grads, ref_grads):
        assert _close(g.to(dtype), r, gtol), name
    assert grads[1].shape[1] == q1 - q0 + (q1 < T)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_shard_gives_the_whole_calls_rows(cuda, case):
    head0, heads, q0, q1, chunk = CASES[case]
    full = _inputs(cuda, torch.float32)
    out, lse, grads = _run(full, chunk, fa.WHOLE)
    x, rows = _cut(full, head0, heads, q0, q1)
    dout = torch.zeros_like(full["dout"])  # the whole call's cotangent of the shard's rows
    dout[rows[:, None], torch.arange(q0, q1, device=cuda)] = full["dout"][rows][:, q0:q1]
    g_full = _run(dict(full, dout=dout), chunk, fa.WHOLE)[2]
    shard = fa.Shard(q0=q0, t_q=T, head0=head0, h_local=heads, h_total=H)
    s_out, s_lse, s_grads = _run(x, chunk, shard)
    q1v = q1 + (q1 < T)
    assert _close(s_out, out[rows][:, q0:q1], 1e-4)
    assert _close(s_lse, lse[rows][:, q0:q1], 1e-5)
    want = (g_full[0][rows][:, q0:q1], g_full[1][rows][:, q0:q1v], g_full[2][rows],
            g_full[3][rows], None)
    for name, g, r in zip(("dq_u", "dqv", "dk", "dv"), s_grads, want):
        assert _close(g, r, 1e-4), name
    assert _close(s_grads[4], g_full[4][head0:head0 + heads], 1e-4)  # the shard's table rows
    assert grads[0].shape == full["q_u"].shape


# the Paraformer's pass-1 calls at bench.py's point (32 rows x 4 heads, U = 48
# queries): self-attention without a mask, source attention over T' = 199
PASS1 = {"self": (48, False), "src_kv_lens": (T, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("head0", [0, 2])
@pytest.mark.parametrize("call", list(PASS1))
def test_k1_at_the_paraformers_pass1_head_offset(cuda, call, head0):
    """K1 in bf16 on heads head0..head0+2 of 4 against the plain version at
    the same offset (2e-2) and against those heads of the whole call (1e-5:
    the same arithmetic)."""
    rows_b, u, d = 32, 48, D
    tk, masked = PASS1[call]
    gen = torch.Generator().manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(cuda, torch.bfloat16)

    args = dict(q=rnd(rows_b * H, u, d), k=rnd(rows_b * H, tk, d), v=rnd(rows_b * H, tk, d))
    if masked:
        kv = torch.randint(tk // 2, tk + 1, (rows_b,), generator=gen)
        args["kv_lens"] = kv.repeat_interleave(H).to(cuda, torch.int32)
    whole = fa.flash_attention(scale=d ** -0.5, **args)
    rows = torch.tensor([b * H + h for b in range(rows_b) for h in range(head0, head0 + 2)],
                        device=cuda)
    cut = {n: x[rows] for n, x in args.items()}
    shard = fa.Shard(head0=head0, h_local=2, h_total=H)
    out = fa.flash_attention(scale=d ** -0.5, shard=shard, **cut)
    ref = fa.flash_attention_plain(scale=d ** -0.5, shard=shard, **cut)
    assert out.shape == (rows_b * 2, u, d)
    assert _close(out, ref, TOL[torch.bfloat16][0])
    assert (out.float() - whole[rows].float()).abs().max().item() <= 1e-5
