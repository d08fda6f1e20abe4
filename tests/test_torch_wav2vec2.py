"""liteasr_tpu_torch's wav2vec 2.0 against liteasr_tpu's, on the CPU in fp32
at the JAX test's tiny widths (tests/test_wav2vec2.py: 1 layer, 32-d, the
3-conv extractor), one flax init carried across by the bridge: the conv
extractor, the quantizer, the encoder, the span mask, the negatives, the
eval and train forwards, the loss and its metrics, every gradient and one
FusedAdam update, the temperature anneal, padded-batch invariance.

torch cannot replay ``jax.random``, so JAX's draws are handed to the port:
the span mask (JAX's forward returns it), the negatives' uniforms of the
key the reference's ``make_rng("negatives")`` gives, and ``jax.random.
gumbel`` of its ``make_rng("gumbel")`` key. The keys are read off a jitted
reference forward by wrapping ``make_rng``; the reference's negative frame
indices by wrapping ``jnp.take_along_axis``. The CLIs:
tests/test_torch_wav2vec2_cli.py; the kernel on the card:
tests/test_torch_wav2vec2_gpu.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liteasr_tpu.models.wav2vec2 as jw
import liteasr_tpu.nets.wav2vec2 as jn
from liteasr_tpu.config.core import DotDict as JaxDotDict
from liteasr_tpu.criterions.wav2vec_loss import Wav2Vec2Loss as JaxLoss
from liteasr_tpu.ops.masks import span_mask as host_span_mask
from liteasr_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from liteasr_tpu_torch.config.core import DotDict
from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss, gumbel_temperature
from liteasr_tpu_torch.models import wav2vec2 as tw
from liteasr_tpu_torch.trainer import to_device

from test_torch_u2 import perturb, t

TOL = 1e-5  # of each output's max; loss and metrics relative
GRAD_TOL = 1e-4  # of each leaf's own max (the key biases: of the largest)
CPU = torch.device("cpu")
CONV = "[(32, 10, 5), (32, 8, 4), (32, 4, 2)]"
TINY = dict(encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
            encoder_attention_heads=2, conv_feature_layers=CONV, latent_vars=8,
            latent_groups=2, num_negatives=4, mask_length=3, mask_prob=0.5, conv_pos=4,
            conv_pos_groups=2, dropout=0.0, attention_dropout=0.0)
RNG_NAMES = ("dropout", "mask", "negatives", "gumbel")


@functools.lru_cache(maxsize=None)
def _jax_init(latent_vars: int = TINY["latent_vars"]):
    """One flax init of the tiny model (jitted)."""
    model = jw.Wav2Vec2(**dict(TINY, latent_vars=latent_vars))
    init = jax.jit(lambda key, x: model.init({"params": key}, x, train=False))
    return jax.device_get(init(jax.random.PRNGKey(0), jnp.zeros((2, 2000))))


def build_pair(seed: int = 0, **overrides):
    """(jax model, numpy variables, torch model) with identical weights: the
    JAX init, perturbed from ``seed`` (of ``overrides``, only
    ``latent_vars`` changes a shape)."""
    cfg = dict(TINY, **overrides)
    variables = perturb(_jax_init(cfg["latent_vars"]), seed)
    tmodel = tw.Wav2Vec2(**cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jw.Wav2Vec2(**cfg), variables, tmodel


def w2v_batch(seed: int, T: int = 2000):
    """Three rows, one shorter, then a weight-0 dummy row (xlens 0), as the
    collator pads them."""
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(4, T)) * 0.1).astype(np.float32)
    xs[3] = 0.0
    return dict(xs=xs, xlens=np.array([T, T, T - 450, 0], np.int32),
                valid=np.array([1, 1, 1, 0], np.float32))


def rngs_of(seed: int):
    return {n: jax.random.PRNGKey(seed + i) for i, n in enumerate(RNG_NAMES)}


def jax_forward(jmodel, variables, b, train: bool, rngs=None, temp=2.0):
    """The reference's forward, jitted, with the draws it made: (logits,
    mask, code_probs, negatives' uniforms (B, F, N), Gumbel noise or None,
    frame indices (B, F, N))."""
    def fwd(variables, xs, xlens, rngs):
        keys, gathers = {}, []
        mp = pytest.MonkeyPatch()

        def recorder(cls):
            orig = cls.make_rng

            def make_rng(self, name):
                keys[name] = orig(self, name)
                return keys[name]

            mp.setattr(cls, "make_rng", make_rng)

        def take_along_axis(a, idx, axis=None, **kw):
            gathers.append(idx)
            return orig_take(a, idx, axis=axis, **kw)

        orig_take = jnp.take_along_axis
        recorder(jw.Wav2Vec2)
        recorder(jn.GumbelVectorQuantizer)
        mp.setattr(jnp, "take_along_axis", take_along_axis)
        try:
            out = jmodel.apply(variables, xs, xlens=xlens, train=train, temp=temp,
                               rngs=rngs)
        finally:
            mp.undo()
        logits, mask, code_probs = out
        B, F = mask.shape
        neg_key = keys.get("negatives", jax.random.PRNGKey(1))
        u = jax.vmap(lambda k: jax.random.uniform(k, (F, jmodel.num_negatives)))(
            jax.vmap(jax.random.fold_in, (None, 0))(neg_key, jnp.arange(B)))
        gumbels = (jax.random.gumbel(keys["gumbel"], (B * F * jmodel.latent_groups,
                                                      jmodel.latent_vars))
                   if train else None)
        idx = gathers[-1].reshape(B, F, -1)  # the gather of the negatives
        return logits, mask, code_probs, u, gumbels, idx

    return jax.device_get(jax.jit(fwd)(variables, jnp.asarray(b["xs"]),
                                       jnp.asarray(b["xlens"]), rngs))


def hand_draws(tmodel, mask, u, gumbels=None):
    """The port's model draws ``mask``, ``u`` and ``gumbels`` (numpy)."""
    tmodel.draw_mask = lambda B, F, flens, train: torch.from_numpy(np.asarray(mask))
    tmodel.draw_negatives_uniform = lambda B, F, train, d: torch.from_numpy(np.asarray(u))
    tmodel.draw_gumbel_noise = lambda n, d: torch.from_numpy(np.asarray(gumbels))


def close_to_max(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max() + 1e-12, what


def logits_match(got, ref, weight=None):
    """The same -inf positions (at the frames ``weight`` (B, F) selects, if
    given), the logits finite on both sides within TOL of their max."""
    got, ref = np.asarray(got), np.asarray(ref)
    sel = np.ones(ref.shape, bool) if weight is None else np.broadcast_to(weight, ref.shape)
    assert np.array_equal(np.isneginf(got) & sel, np.isneginf(ref) & sel)
    fin = np.isfinite(ref) & np.isfinite(got)
    close_to_max(got[fin], ref[fin], "logits")


def _grads_close(got: dict, ref: dict):
    """Each leaf within GRAD_TOL of its own max; the attention key biases,
    whose gradient is 0 in exact arithmetic, within GRAD_TOL of the
    largest gradient."""
    assert set(got) == set(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for name, r in ref.items():
        scale = top if name.endswith(".linear_k.bias") else np.abs(r).max()
        diff = np.abs(got[name] - r).max()
        assert diff <= GRAD_TOL * scale + 1e-12, (name, diff, scale)


@pytest.fixture(scope="module")
def pair():
    return build_pair(0)


# -------------------------------------------------------------- bridge


def test_bridge_round_trip_and_layouts(pair):
    """mask_emb, quantizer/vars, the grouped pos_conv and the extractor's
    ln_<i> survive flax -> torch -> flax bit for bit, in torch's layouts."""
    _, variables, tmodel = pair
    sd = tmodel.state_dict()
    p = variables["params"]
    assert torch.equal(sd["mask_emb"], t(p["mask_emb"]))
    assert torch.equal(sd["quantizer.vars"], t(p["quantizer"]["vars"]))
    kernel = p["encoder"]["pos_conv"]["kernel"]  # (K, I / groups, O)
    assert kernel.shape == (4, 16, 32)
    assert torch.equal(sd["encoder.pos_conv.weight"], t(kernel.transpose(2, 1, 0)))
    assert torch.equal(sd["feature_extractor.ln_1.weight"],
                       t(p["feature_extractor"]["ln_1"]["ln"]["scale"]))
    back = state_dict_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                     jax.tree.leaves(variables)))


def test_config_composes_and_builds_the_same_parameters():
    """``task=pretrain model=wav2vec2 criterion=wav2vec`` composes in the
    port and builds a model whose parameters have the JAX init's shapes; the
    default stack's geometry is /320 with at least one frame."""
    from liteasr_tpu_torch import models
    from liteasr_tpu_torch.config import compose

    cfg = compose(["task=pretrain", "model=wav2vec2", "criterion=wav2vec",
                   "optimizer=my_adam", "task.train=/x", "task.valid=/x",
                   *[f"model.{k}={v}" for k, v in TINY.items()]])
    model = models.build_model(cfg.model, None)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ref = flax_to_state_dict(_jax_init())
    assert shapes == {k: tuple(v.shape) for k, v in ref.items()}
    full = tw.Wav2Vec2(encoder_layers=0)
    assert tw.conv_output_length(56000, full.conv_layers) == 174
    assert full.feature_lengths(torch.tensor([0, 400, 56000])).tolist() == [1, 1, 174]


# ------------------------------------------------------------- modules


def test_extractor_matches_jax(pair):
    _, variables, tmodel = pair
    x = (np.random.default_rng(1).normal(size=(3, 2000)) * 0.1).astype(np.float32)
    ext = jn.ConvFeatureExtractor(conv_layers=tuple(eval(CONV)))
    ref = jax.jit(ext.apply)({"params": variables["params"]["feature_extractor"]}, x)
    with torch.no_grad():
        got = tmodel.feature_extractor(t(x))
    close_to_max(got.numpy(), ref, "extractor")


@pytest.mark.parametrize("train", [False, True])
def test_quantizer_matches_jax(pair, train):
    """Eval: the hard one-hot; train: the straight-through Gumbel softmax at
    JAX's noise and temperature 0.7; ``avg_probs`` weighted by a 0/1 frame
    weight."""
    _, variables, tmodel = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    w = (rng.random((2, 9)) < 0.5).astype(np.float32)
    q = jn.GumbelVectorQuantizer(num_vars=8, groups=2, vq_dim=32)
    noise = []
    orig = jax.random.gumbel

    def apply(params, x, w, key):
        def gumbel(k, shape, *a, **kw):
            noise.append(orig(k, shape, *a, **kw))
            return noise[-1]

        mp = pytest.MonkeyPatch()
        mp.setattr(jax.random, "gumbel", gumbel)
        try:
            out = q.apply({"params": params}, x, temp=0.7, train=train,
                          frame_weight=w, rngs={"gumbel": key})
        finally:
            mp.undo()
        return out, (noise[-1] if train else None)

    (ref, ref_probs), g = jax.device_get(jax.jit(apply)(
        variables["params"]["quantizer"], x, w, jax.random.PRNGKey(3)))
    with torch.no_grad():
        got, probs = tmodel.quantizer(t(x), 0.7, train, frame_weight=t(w),
                                      gumbels=None if g is None else t(g))
    close_to_max(got.numpy(), ref, "quantized")
    close_to_max(probs.numpy(), ref_probs, "avg_probs")


def test_train_codes_are_exactly_one_hot(pair):
    """The training quantizer's output is its codes' codebook rows bit for
    bit, so frames with the same codes give the same target in any
    precision."""
    _, _, tmodel = pair
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 9, 32, generator=gen)
    g = -torch.log(-torch.log(torch.rand(2 * 9 * 2, 8, generator=gen)))
    with torch.no_grad():
        out, _ = tmodel.quantizer(x, 0.7, True, gumbels=g)
        logits = tmodel.quantizer.weight_proj(x).reshape(-1, 8)
    codes = torch.argmax(torch.softmax((logits + g) / 0.7, -1), -1).reshape(18, 2)
    book = tmodel.quantizer.vars[0].reshape(2, 8, 16)
    want = torch.cat([book[0, codes[:, 0]], book[1, codes[:, 1]]], -1).reshape(2, 9, 32)
    assert torch.equal(out, want)


def test_encoder_matches_jax(pair):
    """The conv positional embedding and the layer, eval mode (the port's
    attention through K1's plain version)."""
    _, variables, tmodel = pair
    x = np.random.default_rng(4).normal(size=(2, 11, 32)).astype(np.float32)
    enc = jn.Wav2Vec2TransformerEncoder(
        h_dim=32, ff_dim=64, n_head=2, n_layer=1, dropout_rate=0.0,
        attn_dropout_rate=0.0, ff_dropout_rate=0.0, conv_pos=4, conv_pos_groups=2)
    ref = jax.jit(enc.apply)({"params": variables["params"]["encoder"]}, x)
    with torch.no_grad():
        got = tmodel.encoder(t(x))
    close_to_max(got.numpy(), ref, "encoder")


# ----------------------------------------------------------- span mask


@pytest.mark.parametrize("policy,other", [
    ("static", 0.0), ("uniform", 0.0), ("normal", 3.0), ("poisson", 0.0)])
def test_device_span_mask_matches_host_distribution(policy, other):
    """The masked-frame counts of the port's span mask against the host
    allocator's (ops/masks.span_mask at batch 1, so its equalization is a
    no-op), for every width policy, under tests/test_wav2vec2.py's bound:
    half a span of rounding bias plus 4 standard errors."""
    frame, prob, length, n = 187, 0.65, 10, 600
    gen = torch.Generator().manual_seed(7)
    dev = tw.device_span_mask(gen, n, frame, prob, length, policy=policy, other=other)
    dev_counts = dev.sum(dim=1).double().numpy()
    rng = np.random.default_rng(11)
    host_counts = np.array([
        host_span_mask(1, frame, prob, length, policy=policy, min_mask_num=2,
                       rng=rng).sum() for _ in range(n)], np.float64)
    dm, hm = dev_counts.mean(), host_counts.mean()
    se = np.hypot(dev_counts.std() / np.sqrt(n), host_counts.std() / np.sqrt(n))
    assert abs(dm - hm) <= 0.5 * length + 4 * se, (policy, dm, hm, se)
    if policy == "static":
        assert dev_counts.min() >= length - 1
    assert dev_counts.max() <= prob * frame * 2


def test_span_mask_from_jax_draws_equals_jax():
    """JAX's per-row uniforms (static widths) through the port's
    ``spans_to_mask`` give JAX's mask bit for bit, with ``flens`` cut rows
    and a dummy row (flens 1: frame 0 alone is masked, a reference
    behaviour kept)."""
    key, B, F, prob, L = jax.random.PRNGKey(3), 5, 174, 0.65, 10
    flens = np.array([174, 90, 11, 1, 1], np.int32)
    ref = np.asarray(jax.jit(lambda k, fl: jw.device_span_mask(
        k, B, F, prob, L, flens=fl))(key, flens))
    m = tw.span_mask_count(F, prob, L)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (m,)))(
        jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(B))))
    got = tw.spans_to_mask(t(u), torch.full((B, m), L), F, t(flens).long())
    assert np.array_equal(got.numpy(), ref)
    assert ref[3].sum() == ref[4].sum() == 1 and ref[3, 0] and ref[4, 0]
    assert not ref[1, 90:].any() and not ref[2, 11:].any()


def test_port_span_mask_respects_flens_and_masks_a_dummy_row_at_frame_0():
    gen = torch.Generator().manual_seed(0)
    flens = torch.tensor([174, 60, 1, 1])
    mask = tw.device_span_mask(gen, 4, 174, 0.65, 10, flens=flens)
    counts = mask.sum(dim=1).tolist()
    assert counts[2:] == [1, 1] and bool(mask[2, 0]) and bool(mask[3, 0])
    assert not mask[1, 60:].any() and counts[1] > 0 and counts[0] > 40


# ------------------------------------------------------------ negatives


@pytest.mark.parametrize("everywhere", [False, True])
def test_negative_indices_from_jax_uniforms_equal_jax(everywhere):
    """Both pools: the frames the port picks from JAX's uniforms are the
    frames JAX gathered."""
    jmodel, variables, _ = build_pair(1, negatives_from_everywhere=everywhere)
    b = w2v_batch(5)
    _, mask, _, u, _, idx = jax_forward(jmodel, variables, b, False,
                                        rngs={"mask": jax.random.PRNGKey(3),
                                              "negatives": jax.random.PRNGKey(4)})
    flens = torch.clamp(tw.Wav2Vec2(**TINY).feature_lengths(t(b["xlens"]).long()),
                        max=mask.shape[1])
    got = tw.negative_indices(t(u), t(mask), flens, everywhere)
    assert np.array_equal(got.numpy(), np.asarray(idx))


# ------------------------------------------------------ model and loss


def _port_model(state_dict, draws):
    """A fresh port model with ``state_dict``, drawing ``draws`` (the
    output of :func:`jax_forward`) if given."""
    tmodel = tw.Wav2Vec2(**dict(TINY, latent_vars=state_dict["quantizer.vars"].shape[1] // 2))
    tmodel.load_state_dict(state_dict, strict=True)
    if draws is not None:
        hand_draws(tmodel, draws[1], draws[3], draws[4])
    return tmodel


def _criterion(dw):
    return (JaxLoss(JaxDotDict(diversity_weight=dw)),
            Wav2Vec2Loss(DotDict(diversity_weight=dw)))


@pytest.mark.parametrize("dw", [0.0, 1.0])
def test_eval_forward_and_loss_match_jax(pair, dw):
    """Eval (the validation loss), JAX's fixed-key draws handed over:
    logits with the same -inf positions, the mask (the dummy row's frame 0
    among it), code_probs, loss, accuracy and code_ppl."""
    jmodel, variables, tmodel = pair
    tmodel = _port_model(tmodel.state_dict(), None)
    b = w2v_batch(6)
    logits, mask, code_probs, u, _, _ = jax_forward(jmodel, variables, b, False)
    jcrit, crit = _criterion(dw)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, jaux = jax.device_get(jax.jit(
        lambda v, b: jcrit(jmodel, v, b, train=False))(variables, jb))
    hand_draws(tmodel, mask, u)
    with torch.no_grad():
        got = tmodel(t(b["xs"]), t(b["xlens"]).long(), train=False)
        loss, aux = crit(tmodel, to_device(b, CPU), train=False)
    logits_match(got[0].numpy(), logits)
    weighted = mask & (b["valid"][:, None] > 0)
    assert (np.isneginf(logits) & weighted).any()  # the tiny codebook collides
    assert np.array_equal(got[1].numpy(), mask) and mask[3].tolist() == [True] + [False] * 47
    close_to_max(got[2].numpy(), code_probs, "code_probs")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    for k in ("accuracy", "code_ppl"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=TOL, err_msg=k)


# In training, the reference's straight-through code weight of a frame,
# (1 + y) - y, is 1 or 1 - 2^-24 by the last bit of its softmax y, so two
# frames with the same codes give bit-identical targets (a -inf logit) at
# only some of them; the port's weight is 1 exactly, so they always do.
# The train-mode parity therefore runs at the base configuration's 320
# codes per group, where no two frames the loss weights share their
# codes; the ties are held at eval (tiny codebook), and the port's exact
# one-hot in test_train_codes_are_exactly_one_hot
TRAIN_VARS = 320


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["dw0", "dw1"])
def jax_step(request):
    """JAX's train-mode criterion (dropout 0, step 1000) on the batch with a
    dummy row: loss, metrics and every gradient, with the draws it made."""
    dw = request.param
    jmodel, variables, tmodel = build_pair(2, latent_vars=TRAIN_VARS)
    b = dict(w2v_batch(7), step=np.int32(1000))
    rngs = rngs_of(20)
    temp = jnp.maximum(2.0 * jnp.power(jnp.float32(0.999995), jnp.float32(1000)), 0.5)
    draws = jax_forward(jmodel, variables, b, True, rngs, temp)
    jcrit, _ = _criterion(dw)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params):
        return jcrit(jmodel, {"params": params}, jb, rngs=rngs, train=True)

    (jloss, jaux), jgrads = jax.device_get(jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"]))
    return dw, variables, b, draws, float(jloss), jaux, jgrads, tmodel.state_dict()


def test_train_forward_matches_jax(jax_step):
    """The train forward at JAX's draws: logits (the same -inf positions),
    mask and code_probs."""
    _, _, b, draws, *_, sd = jax_step
    tmodel = _port_model(sd, draws)
    temp = gumbel_temperature(tmodel.latent_temp, 1000)
    with torch.no_grad():
        logits, mask, code_probs = tmodel(t(b["xs"]), t(b["xlens"]).long(), train=True,
                                          temp=temp)
    weighted = draws[1] & (b["valid"][:, None] > 0)
    logits_match(logits.numpy(), draws[0], weighted)
    assert np.array_equal(mask.numpy(), draws[1])
    close_to_max(code_probs.numpy(), draws[2], "code_probs")


def test_train_step_matches_jax(jax_step):
    """Loss, accuracy, code_ppl, every gradient (the codebook's and
    mask_emb's among them) and the params after FusedAdam's update
    against FusedTx's."""
    from liteasr_tpu.optims.fused_step import FusedTx
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule

    dw, variables, b, draws, jloss, jaux, jgrads, sd = jax_step
    tmodel = _port_model(sd, draws)
    _, crit = _criterion(dw)
    loss, aux = crit(tmodel, dict(to_device(b, CPU), step=1000), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL)
    for k in ("accuracy", "code_ppl"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=TOL, err_msg=k)
    ref = flax_to_state_dict({"params": jgrads})
    named = dict(tmodel.named_parameters())
    _grads_close({n: p.grad.numpy() for n, p in named.items()},
                 {n: r.numpy() for n, r in ref.items()})
    for leaf in ("quantizer.vars", "mask_emb", "quantizer.weight_proj.weight"):
        assert np.abs(ref[leaf].numpy()).max() > 0, leaf

    lr, eps = 1e-2, 1e-3  # a large eps: the key biases' gradients are rounding
    fused = FusedTx(lambda s: jnp.full((), lr, jnp.float32), b1=0.9, b2=0.999, eps=eps,
                    clip=5.0)
    jparams, _ = jax.jit(lambda g, p: fused.apply(g, fused.init(p), p))(
        jgrads, variables["params"])
    params = list(named.values())
    FusedAdam(params, constant_schedule(lr), 0.9, 0.999, eps, clip=5.0).update(
        [p.grad for p in params])
    ref_params = flax_to_state_dict({"params": jax.device_get(jparams)})
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_dummy_row_enters_code_usage_as_in_jax():
    """A reference behaviour the port keeps: a dummy row (xlens 0) has one
    feature frame, masked, so it enters code_probs and the diversity term
    (not the CE). At the init's zero LayerNorm biases its all-zero input
    keeps every conv LayerNorm at zero variance, so that term's gradient
    reaches the LayerNorm biases scaled by ~1e6 a layer, in both packages
    alike; without the dummy row the same weights give ordinary
    gradients."""
    _, crit = _criterion(1.0)
    jcrit, _ = _criterion(1.0)
    jmodel, variables = jw.Wav2Vec2(**TINY), _jax_init()
    tmodel = tw.Wav2Vec2(**TINY)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    grads = []
    for b in (w2v_batch(9), {k: v[:3] for k, v in w2v_batch(9).items()}):
        mask, u = jax_forward(jmodel, variables, b, False)[1:4:2]
        hand_draws(tmodel, mask, u)
        loss, _ = crit(tmodel, to_device(b, CPU), train=False)
        tmodel.zero_grad()
        loss.backward()
        grads.append(tmodel.feature_extractor.ln_0.bias.grad.abs().max().item())
    jb = {k: jnp.asarray(v) for k, v in w2v_batch(9).items()}
    jgrads = jax.jit(jax.grad(lambda p: jcrit(jmodel, {"params": p}, jb, train=False)[0]))(
        variables["params"])
    ref = float(np.abs(jgrads["feature_extractor"]["ln_0"]["ln"]["bias"]).max())
    assert grads[0] > 1e9 and ref > 1e9 and grads[1] < 1e3
    np.testing.assert_allclose(grads[0], ref, rtol=1e-3)


@pytest.mark.parametrize("step", [0, 1000, 10 ** 6])
def test_temperature_matches_jax(step):
    """max(2 x 0.999995^step, 0.5) in fp32, as liteasr_tpu/criterions/
    wav2vec_loss.py:58-60 computes it; 10^6 steps reach the floor."""
    lt = (2.0, 0.5, 0.999995)
    ref = jax.jit(lambda s: jnp.maximum(
        lt[0] * jnp.power(jnp.float32(lt[2]), s.astype(jnp.float32)), lt[1]))(
        jnp.int32(step))
    got = gumbel_temperature(lt, step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    assert (got.item() == 0.5) == (step == 10 ** 6)


# ------------------------------------------------------------ padding


@pytest.mark.parametrize("train", [False, True])
def test_padded_batch_invariance(pair, train):
    """Two weight-0 dummy rows appended do not change the loss or the
    accuracy: every draw is row-major, so the real rows draw the same."""
    tmodel = pair[2]
    crit = Wav2Vec2Loss(DotDict(diversity_weight=0.0))
    b = w2v_batch(8)
    small = {k: v[:3] for k, v in b.items()}
    padded = {k: np.concatenate([v, np.zeros_like(v[:2])]) for k, v in small.items()}
    out = []
    for batch in (small, padded):
        tmodel.seed_dropout(3)
        with torch.no_grad():
            loss, aux = crit(tmodel, to_device(batch, CPU), train=train)
        out.append((loss.item(), aux["accuracy"].item()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=TOL)
    assert out[0][1] == out[1][1]


def test_draw_streams():
    """Eval draws are one fixed stream; train draws follow the generators
    that ``seed_dropout`` seeds, which the trainer saves for resume."""
    model = tw.Wav2Vec2(**TINY)
    flens = torch.tensor([48, 30])
    eval_masks = [model.draw_mask(2, 48, flens, False) for _ in range(2)]
    assert torch.equal(*eval_masks)
    model.seed_dropout(1)
    a = (model.draw_mask(2, 48, flens, True), model.draw_negatives_uniform(2, 48, True, CPU),
         model.draw_gumbel_noise(6, CPU))
    b = (model.draw_mask(2, 48, flens, True), model.draw_negatives_uniform(2, 48, True, CPU),
         model.draw_gumbel_noise(6, CPU))
    assert not any(torch.equal(x, y) for x, y in zip(a, b))
    model.seed_dropout(1)
    c = (model.draw_mask(2, 48, flens, True), model.draw_negatives_uniform(2, 48, True, CPU),
         model.draw_gumbel_noise(6, CPU))
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert a[1].shape == (2, 48, 4) and a[2].shape == (6, 8)
