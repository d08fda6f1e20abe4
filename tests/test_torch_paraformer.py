"""liteasr_tpu_torch's Paraformer against liteasr_tpu's, on the CPU in fp32 at
tiny widths, one flax init carried across by the bridge: CIF (the scan and
the closed form, values and gradients), the predictor, the glancing sampler,
the two-pass forward at eval and at train, the loss and its parts, every
gradient, the BatchNorm statistics and one FusedAdam update, the glancing
schedule, and decoding. The encoder's rel-pos attention runs through K1/K3's
plain paths on the port's side.

torch cannot replay JAX's glance noise, so JAX's is handed over: at train,
``jax.random.uniform`` of the key flax derives from the dropout rng (read
off the reference's ``glancing_sample`` call), at eval of ``PRNGKey(0)``,
the reference's fallback. The CLIs: tests/test_torch_paraformer_cli.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liteasr_tpu.models.paraformer as jax_paraformer_module
from liteasr_tpu import decode as jdecode
from liteasr_tpu.config.core import DotDict as JaxDotDict
from liteasr_tpu.models.paraformer import Paraformer as JaxParaformer
from liteasr_tpu.nets import paraformer as jnets
from liteasr_tpu_torch import decode as tdecode
from liteasr_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from liteasr_tpu_torch.config.core import DotDict
from liteasr_tpu_torch.models.paraformer import Paraformer as TorchParaformer
from liteasr_tpu_torch.nets import paraformer as tnets
from liteasr_tpu_torch.trainer import to_device

from test_torch_u2 import perturb, t

TOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's own max (the zero-gradient leaves: of the largest)
CPU = torch.device("cpu")
TINY = dict(input_dim=16, vocab_size=12, enc_dim=32, enc_ff_dim=64, enc_attn_heads=2,
            enc_layers=2, dec_dim=32, dec_ff_dim=64, dec_attn_heads=2, dec_layers=1)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """One flax init of the tiny model (jitted: JAX's eager dispatch compiles
    every op anew and takes longer)."""
    B, T, U = 2, 64, 4
    variables = jax.jit(JaxParaformer(**TINY).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, T, TINY["input_dim"])),
        jnp.full((B,), T), jnp.ones((B, U), jnp.int32), jnp.full((B,), U))
    return jax.device_get(variables)


def japply(jmodel, *args, **kwargs):
    """``jmodel.apply`` under ``jax.jit`` (the keyword arguments static)."""
    fn = jax.jit(lambda *a: jmodel.apply(*a, **kwargs))
    return fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))


def build_pair(seed: int = 0, **overrides):
    """(jax model, numpy variables, torch model) with identical weights: the
    JAX init, perturbed from ``seed`` so that zero biases, unit norms and
    the BatchNorm statistics carry information (``overrides`` leave the
    parameter shapes as they are)."""
    cfg = dict(TINY, **overrides)
    jmodel = JaxParaformer(**cfg)
    variables = perturb(_jax_init(), seed)
    tmodel = TorchParaformer(**cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def para_batch(seed: int, B: int = 3, T: int = 57, U: int = 6):
    """Ragged rows: full, shorter, and a 19-frame row (T' = 3) of 1 label;
    a padding row (valid 0) after them."""
    rng = np.random.default_rng(seed)
    V = TINY["vocab_size"]
    xs = rng.normal(size=(B + 1, T, TINY["input_dim"])).astype(np.float32)
    xs[B] = 0.0
    xlens = np.array([T, T - 13, 19, 23][:B] + [23], np.int32)
    ys = rng.integers(1, V - 1, size=(B + 1, U)).astype(np.int32)
    ylens = np.array([U, 3, 1][:B] + [0], np.int32)
    ys[np.arange(U)[None, :] >= ylens[:, None]] = -1
    return dict(xs=xs, xlens=xlens, ys=ys, ylens=ylens,
                valid=np.array([1.0] * B + [0.0], np.float32))


def eval_noise(B, U):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (B, U)))


def hand_noise(tmodel, noise):
    """The port's model draws ``noise`` (numpy, (B, U)) as its glance noise."""
    tmodel.draw_glance_noise = lambda B, U, train, device: torch.tensor(noise).to(device)


def jax_train_noise(monkeypatch, jmodel, variables, b, rng):
    """The noise the reference's train-mode forward draws (uniform of the
    key flax derives from ``rng``, read off its ``glancing_sample`` call)
    and that forward's (hs_attn, sum_alpha)."""
    orig = jax_paraformer_module.glancing_sample

    def noise_of_forward(variables, b):
        keys = []

        def record(key, *args):
            keys.append(key)
            return orig(key, *args)

        monkeypatch.setattr(jax_paraformer_module, "glancing_sample", record)
        (out, sum_alpha), _ = jmodel.apply(
            variables, b["xs"], b["xlens"], b["ys"], b["ylens"], train=True,
            rngs={"dropout": rng}, mutable=["batch_stats"])
        monkeypatch.setattr(jax_paraformer_module, "glancing_sample", orig)
        assert len(keys) == 1
        return jax.random.uniform(keys[0], b["ys"].shape), out, sum_alpha

    return jax.device_get(jax.jit(noise_of_forward)(variables, b))


def _grads_close(got: dict, ref: dict):
    """Each leaf within GRAD_TOL of its own max; the leaves whose gradient
    is 0 in exact arithmetic (every attention key bias: it shifts a query's
    scores over all keys alike; the depthwise-conv bias in front of
    train-mode BatchNorm) within GRAD_TOL of the step's largest gradient."""
    assert set(got) == set(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for name, r in ref.items():
        zero = name.endswith((".linear_k.bias", ".conv.depthwise_conv.bias"))
        scale = top if zero else np.abs(r).max()
        diff = np.abs(got[name] - r).max()
        assert diff <= GRAD_TOL * scale + 1e-12, (name, diff, scale)


@pytest.fixture(scope="module")
def pair():
    return build_pair(0)


# ---------------------------------------------------------------- CIF


def cif_case(seed, B, T, D, U):
    """tests/test_paraformer.py:33-45's inputs."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, T, D)).astype(np.float32)
    alpha = rng.uniform(0.05, 0.95, size=(B, T)).astype(np.float32)
    xlens = rng.integers(T // 2, T + 1, size=B)
    alpha = np.where(np.arange(T)[None, :] >= xlens[:, None], 0.0, alpha).astype(np.float32)
    ulens = rng.integers(1, U + 1, size=B).astype(np.float32)
    beta = (alpha.sum(axis=1) / ulens - 1e-4).astype(np.float32)
    return alpha, xs, beta


def _port_cif(fn, alpha, xs, beta, U):
    a, x, b = (torch.tensor(v, requires_grad=True) for v in (alpha, xs, beta))
    out = fn(a, x, b, U)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [v.grad.numpy() for v in (a, x, b)]


def _jax_cif(fn, alpha, xs, beta, U):
    args = (jnp.asarray(alpha), jnp.asarray(xs), jnp.asarray(beta))
    out = jax.jit(lambda a, x, b: fn(a, x, b, U))(*args)
    grads = jax.jit(jax.grad(lambda a, x, b: (fn(a, x, b, U) ** 2).sum(),
                             argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close_to_max(got, ref, what):
    """Within TOL of the array's largest magnitude: fp32 sums of up to T
    terms of |x| ~ 50 round differently in the two packages' products."""
    diff = np.abs(got - ref).max()
    assert diff <= TOL * max(1.0, np.abs(ref).max()), (what, diff, np.abs(ref).max())


@pytest.mark.parametrize("seed,B,T,D,U", [
    (0, 3, 40, 8, 7), (1, 2, 64, 16, 12), (2, 4, 25, 4, 25),
])
def test_cif_matches_jax(seed, B, T, D, U):
    """Both of the port's forms against both of JAX's: fire counts first,
    then values and gradients (alpha, xs, beta) within 1e-5 of each array's
    largest magnitude; the port's
    dense against its scan at the JAX test's 2e-4 (values) and 5e-3
    (gradients)."""
    alpha, xs, beta = cif_case(seed, B, T, D, U)
    ref = {"dense": _jax_cif(jnets.cif_dense, alpha, xs, beta, U),
           "scan": _jax_cif(jnets.cif_scan, alpha, xs, beta, U)}
    got = {"dense": _port_cif(tnets.cif_dense, alpha, xs, beta, U),
           "scan": _port_cif(tnets.cif_scan, alpha, xs, beta, U)}
    fires = tnets.fire_counts(torch.cumsum(torch.tensor(alpha), 1), torch.tensor(beta))
    n_fired = np.minimum(fires[:, -1].numpy(), U)
    for form in ("dense", "scan"):
        np.testing.assert_array_equal(
            (np.abs(ref[form][0]).sum(-1) > 0).sum(1), n_fired, err_msg=form)
        for g, r in zip([got[form][0]] + got[form][1], [ref[form][0]] + ref[form][1]):
            _close_to_max(g, r, form)
    np.testing.assert_allclose(got["dense"][0], got["scan"][0], rtol=2e-4, atol=2e-4)
    for g, r in zip(got["dense"][1], got["scan"][1]):
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=5e-3)


def test_cif_dense_degenerate_beta():
    """beta <= 0 (all-zero alpha) gives finite values, JAX's
    (tests/test_paraformer.py:68-77)."""
    B, T, D, U = 2, 10, 4, 5
    alpha = np.zeros((B, T), np.float32)
    xs = np.ones((B, T, D), np.float32)
    beta = (alpha.sum(axis=1) / 3.0 - 1e-4).astype(np.float32)
    out = tnets.cif_dense(t(alpha), t(xs), t(beta), U).numpy()
    assert np.isfinite(out).all()
    ref = jnets.cif_dense(jnp.asarray(alpha), jnp.asarray(xs), jnp.asarray(beta), U)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)


def _predictor_pair(seed, D):
    jpred = jnets.Predictor()
    xs = jnp.zeros((2, 20, D))
    init = jax.jit(lambda key: jpred.init(key, xs, jnp.array([20, 16]), jnp.array([5, 3]),
                                          u_max=5))
    variables = perturb(jax.device_get(init(jax.random.PRNGKey(seed))), seed)
    return jpred, variables


def test_cif_fires_expected_count():
    """With beta = sum / U the predictor fires exactly U times
    (tests/test_paraformer.py:12-30), on the port with JAX's init."""
    B, T, D, U = 2, 20, 8, 5
    jpred, variables = _predictor_pair(0, D)
    pred = tnets.Predictor(D)
    pred.load_state_dict(flax_to_state_dict(variables), strict=True)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(B, T, D)).astype(np.float32)
    with torch.no_grad():
        h_cif, sum_alpha = pred(t(xs), torch.tensor([T, T - 4]), torch.tensor([U, U - 2]),
                                u_max=U)
    assert h_cif.shape == (B, U, D) and sum_alpha.shape == (B,)
    norms = h_cif.abs().sum(-1).numpy()
    assert (norms[0] > 0).all() and (norms[1, :U - 2] > 0).all()
    assert np.allclose(norms[1, U - 2:], 0.0)


@pytest.mark.parametrize("dense", [None, False])
@pytest.mark.parametrize("pad_value", [0.0, 3.0])
def test_predictor_matches_jax(dense, pad_value):
    """h_cif and sum_alpha against JAX within 1e-5, with xlens that leave
    padding; the padded frames zero or not (the SAME conv reads them into
    alpha at the last valid frame), training (ylens) and inference
    lengths; the closed form (the size rule's pick) and the scan."""
    B, T, D, U = 3, 30, 16, 9
    jpred, variables = _predictor_pair(1, D)
    jpred = jpred.clone(dense_cif=dense)
    pred = tnets.Predictor(D, dense_cif=dense)
    pred.load_state_dict(flax_to_state_dict(variables), strict=True)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(B, T, D)).astype(np.float32)
    xlens = np.array([T, 21, 9], np.int32)
    xs[np.arange(T)[None, :] >= xlens[:, None]] = pad_value
    for ylens in (np.array([U, 5, 2], np.int32), None):
        j_cif, j_sum = jpred.apply(variables, jnp.asarray(xs), jnp.asarray(xlens),
                                   None if ylens is None else jnp.asarray(ylens), u_max=U)
        with torch.no_grad():
            h_cif, sum_alpha = pred(t(xs), t(xlens), None if ylens is None else t(ylens),
                                    u_max=U)
        np.testing.assert_allclose(sum_alpha.numpy(), np.asarray(j_sum), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(h_cif.numpy(), np.asarray(j_cif), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.75, 1.0])
def test_glancing_sample_matches_jax(ratio):
    """With JAX's noise handed over, the mixed tensor is JAX's exactly."""
    B, U, D = 4, 9, 6
    rng = np.random.default_rng(3)
    hs = rng.normal(size=(B, U, D)).astype(np.float32)
    emb = rng.normal(size=(B, U, D)).astype(np.float32)
    ys = rng.integers(0, 5, size=(B, U)).astype(np.int32)
    ys_hat = rng.integers(0, 5, size=(B, U)).astype(np.int32)
    ylens = np.array([U, 6, 1, 0], np.int32)
    key = jax.random.PRNGKey(7)
    ref = jnets.glancing_sample(key, hs, emb, ys, ys_hat, ylens, ratio)
    noise = np.asarray(jax.random.uniform(key, (B, U)))
    got = tnets.glancing_sample(t(noise), t(hs), t(emb), t(ys), t(ys_hat), t(ylens), ratio)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------ the bridge, the model


def test_bridge_round_trip_is_exact(pair):
    """A Paraformer variable tree crosses leaf for leaf both ways; the
    predictor's 1-D conv kernel (K, I, O) is Conv1d's (O, I, K)."""
    _, variables, tmodel = pair
    sd = tmodel.state_dict()
    assert set(flax_to_state_dict(variables)) == set(sd)
    kernel = variables["params"]["predictor"]["conv"]["kernel"]
    assert kernel.shape == (3, 32, 32)
    np.testing.assert_array_equal(sd["predictor.conv.weight"].numpy(),
                                  kernel.transpose(2, 1, 0))
    back = state_dict_to_flax(sd)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)


def test_config_composes_in_both_packages():
    """``task=asr model=Paraformer criterion=paraformer_loss`` gives the same
    model and criterion fields and defaults in both packages."""
    from liteasr_tpu.config import compose as jax_compose
    from liteasr_tpu_torch.config import compose

    args = ["task=asr", "model=Paraformer", "criterion=paraformer_loss",
            "optimizer=my_adam", "task.vocab=/x/v.txt", "model.input_dim=16",
            "model.vocab_size=12", "criterion.vocab_size=12"]
    ours, ref = compose(args), jax_compose(args)
    assert dict(ours.model) == dict(ref.model)
    assert dict(ours.criterion) == dict(ref.criterion)
    for key in ("dense_cif", "glance_at_eval", "sample_ratio_end",
                "sample_ratio_decay_steps"):
        assert key in ours.model
    assert ours.criterion.gamma == 1.0


def test_eval_forward_and_decode_match_jax(pair):
    """The two-pass forward at eval (the glance at eval mixes ground truth
    in too, glance_at_eval=True) and the decode against JAX."""
    jmodel, variables, tmodel = pair
    b = para_batch(1)
    j_out, j_sum = japply(jmodel, variables, b["xs"], b["xlens"], b["ys"], b["ylens"])
    hand_noise(tmodel, eval_noise(*b["ys"].shape))
    with torch.no_grad():
        out, sum_alpha = tmodel(t(b["xs"]), t(b["xlens"]), t(b["ys"]).long(), t(b["ylens"]))
    np.testing.assert_allclose(sum_alpha.numpy(), np.asarray(j_sum), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=TOL, atol=TOL)

    u_max = 9
    j_hyp, j_ulens = japply(jmodel, variables, b["xs"], b["xlens"], u_max=u_max,
                            method=jmodel.decode)
    with torch.no_grad():
        hyp, ulens = tmodel.decode(t(b["xs"]), t(b["xlens"]), u_max)
    np.testing.assert_array_equal(hyp.numpy(), np.asarray(j_hyp))
    np.testing.assert_array_equal(ulens.numpy(), np.asarray(j_ulens))


def test_eval_noise_is_a_fixed_stream():
    """Eval draws the same noise every call; train draws from the model's
    seeded generator, which the eval draws leave alone."""
    model = TorchParaformer(**TINY)
    a = model.draw_glance_noise(2, 5, False, CPU)
    assert torch.equal(a, model.draw_glance_noise(2, 5, False, CPU))
    model.seed_dropout(3)
    first = model.draw_glance_noise(2, 5, True, CPU)
    model.seed_dropout(3)
    model.draw_glance_noise(2, 5, False, CPU)
    assert torch.equal(first, model.draw_glance_noise(2, 5, True, CPU))
    assert not torch.equal(first, model.draw_glance_noise(2, 5, True, CPU))


def test_glance_schedule_and_honest_eval(pair):
    """The ratio schedule at steps 0, 50 and 200 (tests/test_paraformer.py:
    109-125) as JAX computes it; glance_at_eval=False scores eval with
    ratio 0, and so differs from the reference's mixing eval forward."""
    jmodel, variables, _ = pair
    sched = jmodel.clone(sample_ratio=0.9, sample_ratio_end=0.0, sample_ratio_decay_steps=100)
    ours = TorchParaformer(**TINY, sample_ratio=0.9, sample_ratio_end=0.0,
                           sample_ratio_decay_steps=100)
    for step, want in ((0, 0.9), (50, 0.45), (200, 0.0)):
        got = float(ours._glance_ratio(True, step))
        assert got == float(sched._glance_ratio(True, jnp.asarray(step)))
        assert got == pytest.approx(want)
    assert ours._glance_ratio(True, None) == 0.9
    assert ours._glance_ratio(False, None) == 0.9

    honest = build_pair(0, glance_at_eval=False)[2]
    assert honest._glance_ratio(False, None) == 0.0
    b = para_batch(2)
    hand_noise(honest, eval_noise(*b["ys"].shape))
    _, _, mixing = build_pair(0)
    hand_noise(mixing, eval_noise(*b["ys"].shape))
    j_honest, _ = japply(jmodel.clone(glance_at_eval=False), variables, b["xs"],
                         b["xlens"], b["ys"], b["ylens"])
    with torch.no_grad():
        args = (t(b["xs"]), t(b["xlens"]), t(b["ys"]).long(), t(b["ylens"]))
        out_honest, out_mixing = honest(*args)[0], mixing(*args)[0]
    np.testing.assert_allclose(out_honest.numpy(), np.asarray(j_honest), rtol=TOL, atol=TOL)
    assert not np.allclose(out_honest.numpy(), out_mixing.numpy())


def test_pass_one_runs_without_gradients():
    """Pass 1 runs in eval mode under no_grad, so its K1 outputs (here the
    plain path's) never enter the autograd graph (K1 has no backward);
    pass 2 runs in train mode with gradients."""
    _, _, tmodel = build_pair(3)
    calls = []
    orig = tmodel.decoder.forward

    def spy(y, memory, memory_mask=None, train=False):
        out = orig(y, memory, memory_mask, train)
        calls.append((train, torch.is_grad_enabled(), out.requires_grad))
        return out

    tmodel.decoder.forward = spy
    b = para_batch(3)
    hand_noise(tmodel, eval_noise(*b["ys"].shape))
    out, _ = tmodel(t(b["xs"]), t(b["xlens"]), t(b["ys"]).long(), t(b["ylens"]), train=True)
    del tmodel.decoder.forward
    assert calls == [(False, False, False), (True, True, True)]
    assert out.requires_grad


@pytest.fixture(scope="module")
def jax_step():
    """JAX's train-mode criterion on a ragged batch with a padding row
    (dropout 0): the loss, its parts, every gradient and the new BatchNorm
    statistics, the glance noise it drew and the forward's outputs."""
    from liteasr_tpu.criterions.paraformer_loss import ParaformerLoss as JaxLoss

    jmodel, variables, tmodel = build_pair(4)
    b = para_batch(4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(11)
    mp = pytest.MonkeyPatch()
    try:
        noise, j_out, j_sum = jax_train_noise(mp, jmodel, variables, jb, rng)
    finally:
        mp.undo()
    jcrit = JaxLoss(JaxDotDict(vocab_size=TINY["vocab_size"], gamma=1.0))

    def loss_fn(params):
        return jcrit(jmodel, {"params": params, "batch_stats": variables["batch_stats"]},
                     jb, rngs={"dropout": rng}, train=True)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return (variables, b, noise, float(jloss), jax.device_get(jaux), jgrads,
            tmodel.state_dict(), (j_out, j_sum))


def _port_model(state_dict, noise):
    tmodel = TorchParaformer(**TINY)
    tmodel.load_state_dict(state_dict, strict=True)
    hand_noise(tmodel, noise)
    return tmodel


def test_train_step_matches_jax(jax_step):
    """One train step with dropout 0 and JAX's glance noise: the loss and
    its parts, every gradient, the BatchNorm statistics after the step and
    the params after FusedAdam's update against FusedTx's."""
    from liteasr_tpu.optims.fused_step import FusedTx
    from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule

    variables, b, noise, jloss, jaux, jgrads, sd, _ = jax_step
    tmodel = _port_model(sd, noise).train()
    crit = ParaformerLoss(DotDict(vocab_size=TINY["vocab_size"], gamma=1.0))
    loss, aux = crit(tmodel, to_device(b, CPU), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL, atol=TOL)
    for part in ("loss_ce", "loss_mae"):
        np.testing.assert_allclose(aux[part].item(), float(jaux[part]), rtol=TOL, atol=TOL)
    ref = flax_to_state_dict({"params": jax.device_get(jgrads)})
    named = dict(tmodel.named_parameters())
    _grads_close({n: p.grad.numpy() for n, p in named.items()},
                 {n: r.numpy() for n, r in ref.items()})
    assert np.abs(ref["predictor.conv.weight"].numpy()).max() > 0  # the MAE term

    new_stats = flax_to_state_dict(
        {"batch_stats": jaux["model_state"]["batch_stats"]})
    buffers = dict(tmodel.named_buffers())
    assert new_stats and set(new_stats) <= set(buffers)
    for name, r in new_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), r.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)

    lr, eps = 1e-2, 1e-3  # a large eps: the key biases' gradients are rounding
    fused = FusedTx(lambda s: jnp.full((), lr, jnp.float32), b1=0.9, b2=0.999, eps=eps,
                    clip=5.0)
    jparams, _ = fused.apply(jgrads, fused.init(variables["params"]), variables["params"])
    params = list(named.values())
    FusedAdam(params, constant_schedule(lr), 0.9, 0.999, eps, clip=5.0).update(
        [p.grad for p in params])
    ref_params = flax_to_state_dict({"params": jax.device_get(jparams)})
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_train_forward_matches_jax(jax_step):
    """The train-mode two-pass forward's outputs against JAX's, the
    glance noise handed over."""
    _, b, noise, _, _, _, sd, (j_out, j_sum) = jax_step
    tmodel = _port_model(sd, noise).train()
    with torch.no_grad():
        out, sum_alpha = tmodel(t(b["xs"]), t(b["xlens"]), t(b["ys"]).long(),
                                t(b["ylens"]), train=True)
    np.testing.assert_allclose(sum_alpha.numpy(), np.asarray(j_sum), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=TOL, atol=TOL)


def test_eval_loss_matches_jax(jax_step):
    """The criterion at eval (the validation loss): loss, loss_ce and
    loss_mae against JAX's, the eval noise handed over."""
    from liteasr_tpu.criterions.paraformer_loss import ParaformerLoss as JaxLoss
    from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss

    variables, b, _, _, _, _, sd, _ = jax_step
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    cfg = dict(vocab_size=TINY["vocab_size"], gamma=0.5)
    jcrit, jmodel = JaxLoss(JaxDotDict(cfg)), JaxParaformer(**TINY)
    jloss, jaux = jax.jit(lambda v, b: jcrit(jmodel, v, b, train=False))(variables, jb)
    tmodel = _port_model(sd, eval_noise(*b["ys"].shape)).eval()
    with torch.no_grad():
        loss, aux = ParaformerLoss(DotDict(cfg))(tmodel, to_device(b, CPU), train=False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    for part in ("loss_ce", "loss_mae"):
        np.testing.assert_allclose(aux[part].item(), float(jaux[part]), rtol=TOL, atol=TOL)


# ------------------------------------------------------------- decoding


@pytest.mark.parametrize("seed", [5, 6])
def test_decode_matches_jax(seed):
    """paraformer_decode of a padded batch gives JAX's tokens (cut at JAX's
    ulens); decode_utterance of a row gives the tokens of JAX's
    ``model.decode`` at the row's own length, as JAX's decode_utterance
    takes them (its eager apply is left out for time)."""
    jmodel, variables, tmodel = build_pair(seed)
    b = para_batch(seed)
    xs, xlens = b["xs"][:3], b["xlens"][:3]
    got = tdecode.paraformer_decode(tmodel, t(xs), t(xlens).long())
    assert got == jdecode.paraformer_decode(jmodel, variables, xs, xlens)
    for row in (1, 2):
        x = xs[row:row + 1, :xlens[row]]
        u_max = max(int(jmodel.get_pred_len(xlens[row])), 1)
        hyp, ulens = japply(jmodel, variables, x, xlens[row:row + 1], u_max=u_max,
                            method=jmodel.decode)
        ref = jdecode.tokens_to_list(np.asarray(hyp)[0], int(np.asarray(ulens)[0]))
        assert tdecode.decode_utterance(tmodel, x[0]) == ref
