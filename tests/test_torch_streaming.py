"""Streaming U2 in liteasr_tpu_torch against liteasr_tpu, on the CPU at tiny
widths (2 layers, 32-d), weights carried from the JAX init by the bridge:

- the chunked attention's plain K1/K1'/K2 (``chunk``) against JAX's XLA
  rel-pos attention under ``triangle_mask(stage=chunk)``, output and every
  input gradient;
- the static-chunk offline encoder against ``U2.encode`` and its causality;
- a ``dynamic_chunk`` train step at the width JAX drew from a fixed key;
- ``streaming_decode`` against JAX's and against the port's own offline
  chunked encoder, greedy and prefix beam, rel-pos and absolute;
- the train CLI -> infer CLI in both streaming modes, and a resumed
  dynamic-chunk run against the uninterrupted one.

On the card (marker ``gpu``, skipped without CUDA): the chunked CUDA kernels
against their plain versions, at widths that straddle a 64-row tile.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from liteasr_tpu_torch.ops import flash_attention as fa

CHUNK_SUB = 8  # emitted subsampled frames per streaming step
N_CHUNKS = 4
T_PAD = 4 * N_CHUNKS * CHUNK_SUB + 4  # the offline length with T' == capacity
STREAM = dict(input_dim=16, vocab_size=12, enc_dim=32, enc_ff_dim=64,
              enc_attn_heads=2, enc_layers=2, dec_dim=32, dec_ff_dim=64,
              dec_attn_heads=2, dec_layers=1, enc_arch="transformer")


def _close_to_max(got, ref, tol, name=""):
    """max |got - ref| within ``tol`` of max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err, peak = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * peak, f"{name}: max abs err {err:.3g} > {tol} x {peak:.3g}"


# ------------------------------------------------------------ the kernels


def _attn_inputs(seed: int, t: int, d: int = 16, b: int = 2, h: int = 2):
    rng = np.random.default_rng(seed)
    bh = b * h

    def mk(*shape):
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    kv = np.resize(np.array([t, t - 9, 0, t - 17], np.int32), bh)  # row 2 is dead
    dout = mk(bh, t, d)
    dout[kv == 0] = 0.0  # XLA sends a dead row's cotangent into dV; the kernels do not
    return dict(q_u=mk(bh, t, d), qv=mk(bh, t, d), k=mk(bh, t, d), v=mk(bh, t, d),
                p=mk(h, t, d), kv_lens=kv, dout=dout)


def _jax_chunked(x, chunk, scale):
    """JAX's XLA rel-pos attention (ac + rel_shift(bd), masked softmax, P V
    as ``RelativeMultiHeadAttention``) under the padding mask and
    ``triangle_mask(stage=chunk)``: the output and the five input grads of
    sum(out * dout), the table's summed over the batch rows."""
    import jax
    import jax.numpy as jnp

    from liteasr_tpu.nets.attention import MASK_FILL, rel_shift
    from liteasr_tpu.ops.masks import triangle_mask

    bh, t, _ = x["q_u"].shape
    hp = x["p"].shape[0]
    mask = (jnp.asarray(triangle_mask(t, stage=chunk)).astype(bool)[None]
            | (jnp.arange(t)[None, None, :] >= jnp.asarray(x["kv_lens"])[:, None, None]))

    def f(q_u, qv, k, v, p):
        p = jnp.tile(p, (bh // hp, 1, 1))
        s = jnp.einsum("bqd,bkd->bqk", q_u, k)
        s = s + rel_shift(jnp.einsum("bqd,bkd->bqk", qv, p)[None])[0]
        s = jnp.where(mask, MASK_FILL, s * scale)
        return jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(s, axis=-1), v)

    args = [jnp.asarray(x[n]) for n in ("q_u", "qv", "k", "v", "p")]
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(x["dout"]))]


@pytest.mark.parametrize("chunk", [1, 3, 4, 25])
def test_chunked_plain_kernels_match_jax(chunk):
    """K3's plain path (K1' forward, K2 backward) with the chunk width, at
    dropout 0, against the XLA attention under the chunk mask; K1 (eval)
    gives the same output."""
    x = _attn_inputs(chunk, 40)
    scale = 16 ** -0.5
    j_out, j_grads = _jax_chunked(x, chunk, scale)
    args = [torch.from_numpy(x[n]).requires_grad_() for n in ("q_u", "qv", "k", "v", "p")]
    kv = torch.from_numpy(x["kv_lens"])
    out = fa.flash_rel_attention_train(*args, kv, 0, scale, 0.0, chunk)
    (out * torch.from_numpy(x["dout"])).sum().backward()
    _close_to_max(out.detach(), j_out, 1e-5, "out")
    for name, a, g in zip(("q_u", "qv", "k", "v", "p"), args, j_grads):
        _close_to_max(a.grad, g, 1e-5, name)
    k1 = fa.flash_attention(args[0].detach(), args[2].detach(), args[3].detach(),
                            kv_lens=kv, rel_qv=args[1].detach(), rel_p=args[4].detach(),
                            scale=scale, chunk=chunk)
    _close_to_max(k1, j_out, 1e-5, "K1")


# ------------------------------------------------------- the offline encoder


@functools.lru_cache(maxsize=None)
def _jax_pair(seed: int, overrides: tuple):
    from test_torch_u2 import build_pair

    jmodel, variables, _ = build_pair(seed, **dict(STREAM, **dict(overrides)))
    return jmodel, variables


def _pair(seed: int = 0, **overrides):
    """(jax model, numpy variables, a fresh torch model) with identical
    weights (``test_torch_u2.build_pair`` at STREAM's widths; the JAX side
    is built once per configuration)."""
    from liteasr_tpu_torch.bridge import flax_to_state_dict
    from liteasr_tpu_torch.models.u2 import U2

    jmodel, variables = _jax_pair(seed, tuple(sorted(overrides.items())))
    tmodel = U2(**dict(STREAM, **overrides))
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def _stream_batch(seed: int = 3):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(2, T_PAD, 16)).astype(np.float32)
    xlens = np.array([T_PAD, T_PAD - 37], np.int32)
    xs[1, xlens[1]:] = 0.0
    return xs, xlens


@pytest.mark.parametrize("arch,use_rel", [("transformer", True), ("transformer", False),
                                          ("conformer", True)])
def test_static_chunk_encoder_matches_jax(arch, use_rel):
    """The static-chunk offline encoder (the chunk width through K1) equals
    U2.encode under the materialized chunk mask."""
    from test_torch_u2 import TOL, t

    jmodel, variables, tmodel = _pair(1, enc_arch=arch, use_rel=use_rel,
                                      static_chunk_size=4)
    xs, xlens = _stream_batch(4)
    j_enc, j_mask = jmodel.apply(variables, xs, xlens, method=jmodel.encode)
    with torch.no_grad():
        enc, mask = tmodel.encode(t(xs), t(xlens))
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))


def test_chunked_encoder_is_causal_across_chunks():
    """tests/test_streaming.py on the port: perturbing the last quarter of
    the input leaves every frame whose chunk ends before it unchanged, and
    a full-context encoder of the same weights does move them."""
    from liteasr_tpu_torch.models.u2 import U2

    gen = torch.Generator().manual_seed(0)
    T = 128
    xs = torch.from_numpy(np.random.default_rng(0).normal(size=(1, T, 16)).astype(np.float32))
    xlens = torch.tensor([T])
    xs2 = xs.clone()
    xs2[:, 3 * T // 4:] += 10.0
    model = U2(**STREAM, static_chunk_size=4, generator=gen)
    with torch.no_grad():
        h1, h2 = (model.encode(x, xlens)[0] for x in (xs, xs2))
        f1, f2 = (model.encoder(x, chunk=0) for x in (xs, xs2))
    safe = ((3 * T // 4) // 4 - 4) // 4 * 4  # clear of the conv's receptive field
    assert (h1 - h2)[0, :safe].abs().max() < 1e-4
    assert (h1 - h2)[0, -1].abs().max() > 1e-3
    assert (f1 - f2)[0, :safe].abs().max() > 1e-3


# ------------------------------------------------------ dynamic-chunk training


def _jax_width(jmodel, variables, key):
    """The width U2's encoder draws from the ``chunk`` rng ``key``
    (liteasr_tpu/nets/encoder.py:144-158); 0 for full context."""
    import jax

    enc_key = jmodel.apply(variables, rngs={"chunk": key},
                           method=lambda m: m.encoder.make_rng("chunk"))
    k1, k2 = jax.random.split(enc_key)
    if bool(jax.random.uniform(k1) < 0.5):
        return 0
    return int(jax.random.randint(k2, (), 1, 26))


@pytest.mark.parametrize("kind", ["full", "chunked"])
def test_dynamic_chunk_train_step_matches_jax(kind):
    """One dynamic-chunk train step (dropout 0): the JAX package draws the
    width from a fixed ``chunk`` key, the port takes that width; the loss
    and every gradient agree within 1e-4 of each leaf's max (the key
    biases, whose gradient is 0 in exact arithmetic, of the largest)."""
    import jax
    import jax.numpy as jnp

    from liteasr_tpu.config.core import DotDict as JaxDotDict
    from liteasr_tpu.criterions.hybrid_ctc_attn import HybridCTCLoss as JaxLoss
    from liteasr_tpu_torch.bridge import flax_to_state_dict
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss
    from test_torch_train import _batch, _cfg, _torch_batch

    jmodel, variables, tmodel = _pair(6, vocab_size=30, dynamic_chunk=True)
    b = _batch(6)
    t_sub = ((b["xs"].shape[1] - 1) // 2 - 1) // 2
    want = (lambda w: w == 0) if kind == "full" else (lambda w: 1 < w < t_sub)
    key, width = next((k, w) for k, w in (
        (k, _jax_width(jmodel, variables, k)) for k in map(jax.random.PRNGKey, range(64)))
        if want(w))

    jcrit = JaxLoss(JaxDotDict(_cfg()))
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params):
        return jcrit(jmodel, {"params": params}, jb, rngs={"chunk": key}, train=True)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    with mock.patch.object(tmodel.encoder, "draw_chunk", return_value=width):
        loss, _ = HybridCTCLoss(DotDict(_cfg()))(tmodel, _torch_batch(b), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    ref = flax_to_state_dict({"params": jax.device_get(jgrads)})
    top = max(g.abs().max().item() for g in ref.values())
    for name, p in tmodel.named_parameters():
        if name.endswith(".linear_k.bias"):
            assert (p.grad - ref[name]).abs().max().item() <= 1e-4 * top, name
        else:
            _close_to_max(p.grad.numpy(), ref[name].numpy(), 1e-4, name)


def test_dynamic_draws_come_from_the_chunk_generator():
    """Train-mode forwards draw widths (both kinds occur, seeded), eval and
    a static model draw none, and the encoder hands a drawn width to every
    layer."""
    from liteasr_tpu_torch.models.u2 import U2

    model = U2(**STREAM, dynamic_chunk=True, generator=torch.Generator().manual_seed(0))
    model.seed_dropout(5)
    draws = [model.encoder.draw_chunk() for _ in range(40)]
    model.seed_dropout(5)
    assert draws == [model.encoder.draw_chunk() for _ in range(40)]
    assert 0 in draws and all(0 <= w <= 25 for w in draws) and len(set(draws)) > 5
    xs, xlens = torch.randn(2, 64, 16), torch.tensor([64, 50])
    state = model.chunk_generator.get_state()
    with torch.no_grad():
        model.encoder(xs, train=False)
        assert torch.equal(model.chunk_generator.get_state(), state)
        with mock.patch.object(model.encoder.layer_0, "forward",
                               wraps=model.encoder.layer_0.forward) as layer:
            model.encoder(xs, train=True)
        assert not torch.equal(model.chunk_generator.get_state(), state)
    model.chunk_generator.set_state(state)
    assert layer.call_args.args[-1] == model.encoder.draw_chunk()


# ------------------------------------------------------------ the streaming runtime


@pytest.mark.parametrize("mode", ["ctc_greedy", "ctc_prefix_beam_search"])
@pytest.mark.parametrize("use_rel", [True, False])
def test_streaming_decode_matches_jax(use_rel, mode):
    """The port's chunk-by-chunk runtime against JAX's: identical
    hypotheses, the stream's hidden states within 1e-5."""
    from liteasr_tpu.streaming import streaming_decode as jax_streaming
    from liteasr_tpu_torch.streaming import streaming_decode
    from test_torch_u2 import t

    jmodel, variables, tmodel = _pair(2, use_rel=use_rel, static_chunk_size=4)
    xs, xlens = _stream_batch()
    j_hyps, j_enc = jax_streaming(jmodel, variables, xs, xlens, chunk_sub=CHUNK_SUB,
                                  mode=mode, beam_size=5, n_chunks=N_CHUNKS,
                                  collect_enc=True)
    hyps, enc = streaming_decode(tmodel, t(xs), t(xlens), chunk_sub=CHUNK_SUB,
                                 mode=mode, beam_size=5, n_chunks=N_CHUNKS,
                                 collect_enc=True)
    assert hyps == j_hyps
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_rel", [True, False])
def test_streaming_equals_the_offline_chunked_encoder(use_rel):
    """Streaming reproduces the port's offline chunked encoder on every
    valid frame (rtol 1e-4, atol 1e-5), and its greedy and prefix-beam
    hypotheses are the offline ones."""
    from liteasr_tpu_torch import decode
    from liteasr_tpu_torch.models.u2 import U2
    from liteasr_tpu_torch.nets.subsampling import subsampled_length
    from liteasr_tpu_torch.streaming import streaming_decode
    from test_torch_u2 import t

    model = U2(**STREAM, use_rel=use_rel, static_chunk_size=4,
               generator=torch.Generator().manual_seed(1)).eval()
    xs, xlens = (t(a) for a in _stream_batch(5))
    with torch.no_grad():
        h_off, _ = model.encode(xs, xlens)
        logp = torch.log_softmax(model.ctc_logits(h_off).float(), -1)
    hyps, h_str = streaming_decode(model, xs, xlens, chunk_sub=CHUNK_SUB,
                                   n_chunks=N_CHUNKS, collect_enc=True)
    for b, n in enumerate(xlens.tolist()):
        ls = subsampled_length(n)
        torch.testing.assert_close(h_str[b, :ls], h_off[b, :ls], rtol=1e-4, atol=1e-5)
    assert hyps == decode.decode_batch(model, xs, xlens, mode="ctc_greedy")
    enc_lens = torch.tensor([subsampled_length(n) for n in xlens.tolist()])
    prefixes, plens, _ = decode.ctc_prefix_beam_search(logp, enc_lens, beam_size=5)
    beam = streaming_decode(model, xs, xlens, chunk_sub=CHUNK_SUB, n_chunks=N_CHUNKS,
                            mode="ctc_prefix_beam_search", beam_size=5)
    assert beam == [prefixes[b, 0, :plens[b, 0]].tolist() for b in range(2)]


@pytest.mark.parametrize("case", ["chunk_sub", "conformer", "post_ln"])
def test_streaming_refuses_what_it_cannot_stream(case):
    """chunk_sub must be a multiple of static_chunk_size (JAX asserts it);
    the conformer's conv module and post-LN layers are not chunk-causal
    (liteasr_tpu/nets/encoder.py:63-65, layers.py:139)."""
    from liteasr_tpu_torch.models.u2 import U2
    from liteasr_tpu_torch.streaming import streaming_decode

    kw = {"chunk_sub": dict(static_chunk_size=3), "conformer": dict(enc_arch="conformer"),
          "post_ln": dict(normalize_before=False)}[case]
    model = U2(**dict(STREAM, **kw), generator=torch.Generator().manual_seed(0))
    xs, xlens = torch.randn(1, 68, 16), torch.tensor([68])
    with pytest.raises(ValueError, match={"chunk_sub": "multiple", "conformer": "conformer",
                                          "post_ln": "pre-LN"}[case]):
        streaming_decode(model, xs, xlens, chunk_sub=8)


# ------------------------------------------------------------ the CLIs


def test_train_cli_then_infer_cli_in_both_streaming_modes(tiny_corpus, tmp_path):
    from liteasr_tpu_torch import infer, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml
    from test_torch_train import _train_overrides

    trainer = train.main(_train_overrides(tiny_corpus, tmp_path)
                         + ["model.enc_arch=transformer", "model.dynamic_chunk=true"],
                         device=torch.device("cpu"))
    assert trainer.model.encoder.dynamic_chunk and trainer.epoch == 1
    base = load_yaml(str(tmp_path / "config.yaml"))
    for mode in ("streaming_ctc_greedy", "streaming_ctc_prefix_beam_search"):
        pairs = tmp_path / f"{mode}.txt"
        cfg = compose(["inference.ckpt_name=1", "inference.model_avg=false",
                       "inference.batch_size=2", "inference.beam_size=3",
                       f"inference.mode={mode}", "inference.chunk_sub=4",
                       f"inference.dump={pairs}"], base=base)
        results = infer.infer(cfg, device=torch.device("cpu"))
        assert len(results) == 1 and results[0][1] > 0
        assert len(pairs.read_text().splitlines()) == 4  # every test utterance


def test_resumed_dynamic_chunk_run_equals_the_uninterrupted_one(tiny_corpus, tmp_path):
    """1 epoch + resume == 2 epochs: the chunk generator joins the resume
    state, so the second epoch draws the widths the uninterrupted run drew."""
    from test_torch_resume import _overrides, _train

    extra = ["postprocess.workflow=[]", "model.enc_arch=transformer",
             "model.dynamic_chunk=true"]
    whole = _train(_overrides(tiny_corpus, tmp_path / "whole", *extra,
                              "optimization.max_epoch=2"))
    _train(_overrides(tiny_corpus, tmp_path / "split", *extra, "optimization.max_epoch=1"))
    resumed = _train(_overrides(tiny_corpus, tmp_path / "split", *extra,
                                "optimization.max_epoch=2", "common.resume=auto"))
    assert (resumed.epoch, resumed.step) == (whole.epoch, whole.step) == (2, 6)
    assert torch.equal(resumed.model.chunk_generator.get_state(),
                       whole.model.chunk_generator.get_state())
    ref = whole.model.state_dict()
    for name, val in resumed.model.state_dict().items():
        assert torch.equal(val, ref[name]), name


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ftol,gtol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 2e-2, 5e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("chunk", [1, 5, 16, 25, 64, 70])
@pytest.mark.parametrize("t,d", [(199, 64), (130, 100), (48, 32)])
def test_chunked_kernels_match_plain(cuda, dtype, ftol, gtol, rate, chunk, t, d):
    """K1' and K2 (through K3) and K1 with a chunk width against the plain
    versions: widths that do not divide 64 put a chunk across a query
    tile's edge, where some rows of a tile keep lookahead keys (read through
    the crossover q_v row) and others lose all of theirs."""
    x = _attn_inputs(chunk + t, t, d)
    x["kv_lens"][1] = 1
    scale, seed = d ** -0.5, 99
    ins = [torch.from_numpy(x[n]).to(cuda, dtype) for n in ("q_u", "qv", "k", "v", "p")]
    kv = torch.from_numpy(x["kv_lens"]).to(cuda)
    dout = torch.from_numpy(x["dout"]).to(cuda)
    args = [a.clone().requires_grad_() for a in ins]
    before = _chunk_counts()
    out = fa.flash_rel_attention_train(*args, kv, seed, scale, rate, chunk)
    (out * dout).sum().backward()
    ref_out, ref_lse = fa.flash_attention_plain(
        ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4], scale=scale,
        return_lse=True, dropout_rate=rate, dropout_seed=seed, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out.float(), rtol=ftol, atol=ftol)
    ref_grads = fa.flash_rel_attention_bwd_plain(*ins, kv, out.detach(), ref_lse, dout,
                                                 scale, rate, seed, chunk)
    for name, a, r in zip(("q_u", "qv", "k", "v", "p"), args, ref_grads):
        torch.testing.assert_close(a.grad.float(), r, rtol=gtol, atol=gtol, msg=name)
    k1 = fa.flash_attention(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1],
                            rel_p=ins[4], scale=scale, chunk=chunk)
    k1_ref = fa.flash_attention_plain(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1],
                                      rel_p=ins[4], scale=scale, chunk=chunk)
    torch.testing.assert_close(k1.float(), k1_ref.float(), rtol=ftol, atol=ftol)
    # K1' and K1, K1' alone, K2: each launched once with the chunk width
    assert [a - b for a, b in zip(_chunk_counts(), before)] == [2, 1, 1]


def _chunk_counts():
    return [fa.flash_attention.chunk_launches, fa.flash_attention.lse_chunk_launches,
            fa.flash_rel_attention_bwd.chunk_launches]


def test_plain_chunked_calls_count_no_launch():
    """A CPU tensor takes the plain versions, which launch nothing: the
    chunked-launch counts stay as they were."""
    x = _attn_inputs(0, 12, 8)
    ins = [torch.from_numpy(x[n]) for n in ("q_u", "qv", "k", "v", "p")]
    kv = torch.from_numpy(x["kv_lens"])
    before = _chunk_counts()
    out = fa.flash_rel_attention_train(*[a.clone().requires_grad_() for a in ins], kv, 0,
                                       0.25, 0.0, 4)
    out.sum().backward()
    fa.flash_attention(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4],
                       chunk=4)
    assert _chunk_counts() == before
