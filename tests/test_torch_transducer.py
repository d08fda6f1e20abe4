"""liteasr_tpu_torch's transducer against liteasr_tpu's, on the CPU in fp32 at
tiny widths, one flax init carried across by the bridge: the LSTM
prediction network (full forward, steps, forget bias, the packed bridge),
the lattice, the RNN-T criterion and one whole train step (loss, every
gradient, the updated params); greedy, the batched beam and the utterance
beam (identical hypotheses), the beam against exhaustive search at one
emission per frame. The CLIs: tests/test_torch_transducer_cli.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu import decode as jdecode
from liteasr_tpu.config.core import DotDict as JaxDotDict
from liteasr_tpu.models.transducer import Transducer as JaxTransducer
from liteasr_tpu_torch import decode as tdecode
from liteasr_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from liteasr_tpu_torch.config.core import DotDict
from liteasr_tpu_torch.models.transducer import Transducer as TorchTransducer

from test_torch_u2 import perturb, t

TOL = 1e-5
GRAD_TOL = 1e-4  # relative, as test_torch_train's grads (with atol 1e-5)
CPU = torch.device("cpu")
TD = dict(input_dim=16, vocab_size=12, joint_dim=24, enc_dim=32, enc_ff_dim=64,
          enc_attn_heads=4, enc_layers=2, dec_dim=16, dec_units=20, dec_layers=2)


def build_td_pair(seed: int = 0, joint_scale: float = 1.0, **overrides):
    """(jax model, numpy variables, torch model) with identical weights: the
    JAX init with the trainer's forget-bias edit, perturbed; ``lin_jnt``
    scaled by ``joint_scale`` for peaked posteriors."""
    cfg = dict(TD, **overrides)
    jmodel = JaxTransducer(**cfg)
    B, T = 2, 64
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((B, T, cfg["input_dim"])),
        jnp.full((B,), T), jnp.ones((B, 4), jnp.int32), jnp.full((B,), 4))
    params = jmodel.post_init_params(jax.device_get(variables)["params"])
    variables = perturb({"params": params}, seed)
    jnt = variables["params"]["lin_jnt"]
    jnt["kernel"], jnt["bias"] = jnt["kernel"] * joint_scale, jnt["bias"] * joint_scale
    tmodel = TorchTransducer(**cfg)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def td_batch(seed: int, B: int = 3, T: int = 57, U: int = 6, V: int = TD["vocab_size"]):
    """Ragged rows: full, shorter, and a 19-frame row (T' = 3) of 1 label."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, T, TD["input_dim"])).astype(np.float32)
    xlens = np.array([T, T - 13, 19][:B], np.int32)
    ys = rng.integers(1, V, size=(B, U)).astype(np.int32)
    ylens = np.array([U, 3, 1][:B], np.int32)
    ys[np.arange(U)[None, :] >= ylens[:, None]] = -1
    return xs, xlens, ys, ylens


@pytest.fixture(scope="module")
def pair():
    return build_td_pair(0)


# ------------------------------------------------- the prediction network


def test_bridge_packs_the_lstm_and_round_trips(pair):
    _, variables, tmodel = pair
    sd = tmodel.state_dict()
    assert set(flax_to_state_dict(variables)) == set(sd)
    H = TD["dec_units"]
    cell = variables["params"]["decoder"]["rnn_1"]["cell"]
    packed = {n: sd[f"decoder.rnn_1.cell.{n}"].numpy()
              for n in ("weight_ih", "weight_hh", "bias")}
    assert packed["weight_ih"].shape == (4 * H, H) and packed["bias"].shape == (4 * H,)
    for i, g in enumerate("ifgo"):
        rows = slice(i * H, (i + 1) * H)
        np.testing.assert_array_equal(packed["weight_ih"][rows], cell[f"i{g}"]["kernel"].T)
        np.testing.assert_array_equal(packed["weight_hh"][rows], cell[f"h{g}"]["kernel"].T)
        np.testing.assert_array_equal(packed["bias"][rows], cell[f"h{g}"]["bias"])
    back = state_dict_to_flax(sd)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)
    again = flax_to_state_dict(back)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


def test_one_trainable_bias_per_gate(pair):
    _, _, tmodel = pair
    cell = tmodel.decoder.rnn_0.cell
    names = {n for n, _ in cell.named_parameters()}
    assert names == {"weight_ih", "weight_hh", "bias"}
    assert "zero_bias" not in tmodel.state_dict() and not cell.zero_bias.any()


def test_prediction_network_matches_jax(pair):
    """The full-sequence forward and the decode steps, against JAX; the
    port's steps from its init_state equal its own full forward."""
    jmodel, variables, tmodel = pair
    rng = np.random.default_rng(1)
    ys = rng.integers(0, TD["vocab_size"], size=(3, 7)).astype(np.int32)
    j_full = jmodel.apply(variables, ys, method=lambda m, y: m.decoder(y))
    j_state = jmodel.apply(variables, 3, method=jmodel.decoder_init_state)
    state = tmodel.decoder_init_state(3)
    with torch.no_grad():
        full = tmodel.decoder(t(ys).long())
        for j in range(ys.shape[1]):
            j_out, j_state = jmodel.apply(variables, ys[:, j], j_state,
                                          method=jmodel.decoder_step)
            out, state = tmodel.decoder_step(t(ys[:, j]).long(), state)
            np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(out.numpy(), full[:, j].numpy(), rtol=TOL, atol=TOL)
            for (c, h), (jc, jh) in zip(state, j_state):  # the carry is (c, h)
                np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
                np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), rtol=TOL, atol=TOL)


def test_fresh_init_follows_flax_with_forget_bias_one():
    """A fresh port model: the forget-gate biases where JAX's
    ``forget_bias_ones`` (Transducer.post_init_params) puts them, every
    other bias 0, orthogonal recurrent kernels per gate, N(0, 1)
    embeddings."""
    from liteasr_tpu.nets.rnn_decoder import forget_bias_ones

    tmodel = TorchTransducer(**dict(TD, dec_units=64, vocab_size=500),
                             generator=torch.Generator().manual_seed(0))
    sd = tmodel.state_dict()
    zeroed = {k: torch.zeros_like(v) if k.endswith("cell.bias") else v
              for k, v in sd.items()}
    params = state_dict_to_flax(zeroed)["params"]
    edited = flax_to_state_dict({"params": dict(
        params, decoder=jax.device_get(forget_bias_ones(params["decoder"])))})
    for i in range(TD["dec_layers"]):
        cell = getattr(tmodel.decoder, f"rnn_{i}").cell
        H = cell.units
        bias = cell.bias.detach()
        np.testing.assert_array_equal(bias.numpy(),
                                      edited[f"decoder.rnn_{i}.cell.bias"].numpy())
        assert bool((bias[H:2 * H] == 1).all()) and int(torch.count_nonzero(bias)) == H
        for w in cell.weight_hh.detach().split(H):
            torch.testing.assert_close(w @ w.T, torch.eye(H), rtol=0, atol=1e-5)
    emb = tmodel.decoder.embed.weight.detach()
    assert abs(emb.std().item() - 1.0) < 0.05 and abs(emb.mean().item()) < 0.05


# ------------------------------------------- the lattice, loss, train step


def test_lattice_matches_jax(pair):
    jmodel, variables, tmodel = pair
    xs, xlens, ys, ylens = td_batch(2)
    j_lat = jmodel.apply(variables, xs, xlens, ys, ylens)
    with torch.no_grad():
        lat = tmodel(t(xs), t(xlens), t(ys).long(), t(ylens))
    assert lat.shape == j_lat.shape == (3, 13, 7, TD["vocab_size"])
    np.testing.assert_allclose(lat.numpy(), np.asarray(j_lat), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tmodel.get_pred_len(t(xlens)).numpy(),
                                  np.asarray(jmodel.get_pred_len(jnp.asarray(xlens))))


def _batch(seed):
    """td_batch plus a padding row (valid 0)."""
    xs, xlens, ys, ylens = td_batch(seed)
    return dict(xs=np.concatenate([xs, np.zeros_like(xs[:1])]),
                xlens=np.append(xlens, 23).astype(np.int32),
                ys=np.concatenate([ys, np.full((1, ys.shape[1]), -1, np.int32)]),
                ylens=np.append(ylens, 0).astype(np.int32),
                valid=np.array([1, 1, 1, 0], np.float32))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX criterion's loss and gradients on a ragged batch with a
    padding row (dropout 0, so train and eval mode agree)."""
    from liteasr_tpu.criterions.rnnt import RNNTLoss as JaxLoss

    jmodel, variables, tmodel = build_td_pair(4)
    b = _batch(4)
    jcrit = JaxLoss(JaxDotDict(blank_id=0))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jcrit(jmodel, {"params": p}, jb, rngs=None, train=True)[0]))(
        variables["params"])
    return variables, b, float(jloss), jgrads, tmodel.state_dict()


def _port_model(state_dict):
    tmodel = TorchTransducer(**TD)
    tmodel.load_state_dict(state_dict, strict=True)
    return tmodel


def _check_grads(tmodel, jgrads):
    ref = flax_to_state_dict({"params": jax.device_get(jgrads)})
    named = dict(tmodel.named_parameters())
    assert set(ref) == set(named)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=GRAD_TOL,
                                   atol=TOL, err_msg=name)


def test_criterion_loss_and_grads_match_jax(jax_step):
    from liteasr_tpu_torch.criterions.rnnt import RNNTLoss
    from liteasr_tpu_torch.trainer import to_device

    _, b, jloss, jgrads, sd = jax_step
    tmodel = _port_model(sd).eval()
    loss, aux = RNNTLoss(DotDict(blank_id=0))(tmodel, to_device(b, CPU), train=False)
    loss.backward()
    assert aux == {}
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL, atol=TOL)
    _check_grads(tmodel, jgrads)


def test_train_step_matches_jax(jax_step):
    """One train-mode step with dropout 0: loss, every gradient and the
    params after FusedAdam's update against FusedTx's."""
    from liteasr_tpu.optims.fused_step import FusedTx
    from liteasr_tpu_torch.criterions.rnnt import RNNTLoss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule
    from liteasr_tpu_torch.trainer import to_device

    variables, b, jloss, jgrads, sd = jax_step
    tmodel = _port_model(sd).train()
    # Adam with a large eps: the attention key biases, whose gradient is 0
    # up to rounding, must not be normalized to +-lr
    lr, eps = 1e-2, 1e-3
    fused = FusedTx(lambda s: jnp.full((), lr, jnp.float32), b1=0.9, b2=0.999,
                    eps=eps, clip=5.0)
    jparams, _ = fused.apply(jgrads, fused.init(variables["params"]), variables["params"])

    loss, _ = RNNTLoss(DotDict(blank_id=0))(tmodel, to_device(b, CPU), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL, atol=TOL)
    _check_grads(tmodel, jgrads)
    params = list(tmodel.parameters())
    FusedAdam(params, constant_schedule(lr), 0.9, 0.999, eps, clip=5.0).update(
        [p.grad for p in params])
    ref = flax_to_state_dict({"params": jax.device_get(jparams)})
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_dec_arch_other_than_lstm_raises():
    from liteasr_tpu_torch import models
    from liteasr_tpu_torch.config import compose

    cfg = compose(["task=asr", "model=my_transducer", "task.vocab=/x/v.txt",
                   "model.input_dim=16", "model.vocab_size=12",
                   "model.dec_arch=transformer"])
    with pytest.raises(NotImplementedError, match="LSTM"):
        models.build_model(cfg.model)


# ------------------------------------------------------------- decoding


@pytest.mark.parametrize("seed,joint_scale", [(5, 1.0), (6, 4.0), (7, 8.0)])
def test_greedy_and_batched_beam_match_jax(seed, joint_scale):
    jmodel, variables, tmodel = build_td_pair(seed, joint_scale)
    xs, xlens, _, _ = td_batch(seed)
    assert tdecode.transducer_greedy(tmodel, t(xs), t(xlens)) == \
        jdecode.transducer_greedy(jmodel, variables, xs, xlens)
    for beam, expansions in ((3, 5), (5, 2)):
        got = tdecode.transducer_beam_search(tmodel, t(xs), t(xlens), beam_size=beam,
                                             expansions_per_frame=expansions)
        ref = jdecode.transducer_beam_search(jmodel, variables, xs, xlens, beam_size=beam,
                                             expansions_per_frame=expansions)
        assert got == ref, (beam, expansions)


@pytest.mark.parametrize("seed,joint_scale,row", [(8, 1.0, 0), (9, 4.0, 2)])
def test_utterance_beam_matches_jax(seed, joint_scale, row):
    """A full row, and the 3-frame row with peaked posteriors."""
    jmodel, variables, tmodel = build_td_pair(seed, joint_scale)
    xs, xlens, _, _ = td_batch(seed)
    x = xs[row, :xlens[row]]
    assert tdecode.transducer_beam_search_utt(tmodel, x, beam_size=3) == \
        jdecode.transducer_beam_search_utt(jmodel, variables, jnp.asarray(x), beam_size=3)


def _exhaustive_best(model, h_enc_b, V):
    """Every path of at most one emission per frame through the port's
    model, scored as the beam scores: log-probs summed, a blank closing
    each frame, divided by the emissions + 1."""
    def logp(h_t, dec_out):
        return torch.log_softmax(model.joint(h_t[None], dec_out), -1)[0]

    best_score, best_seq = -np.inf, []
    state0 = model.decoder_init_state(1)
    for choices in itertools.product(range(V), repeat=h_enc_b.shape[0]):
        state, last, seq, score = state0, 0, [], 0.0
        for t_, c in enumerate(choices):
            dec_out, new_state = model.decoder_step(torch.tensor([last]), state)
            lp = logp(h_enc_b[t_], dec_out)
            score += float(lp[c])
            if c != 0:
                seq.append(c)
                state, last = new_state, c
                dec_out2, _ = model.decoder_step(torch.tensor([last]), state)
                score += float(logp(h_enc_b[t_], dec_out2)[0])
        if score / (len(seq) + 1) > best_score:
            best_score, best_seq = score / (len(seq) + 1), seq
    return best_seq


def test_beam_is_exhaustive_at_one_emission_per_frame():
    """With K >= V^T' paths and E=1 (at most one emission per frame, what
    the oracle enumerates), the beam is exhaustive search."""
    V = 4
    tmodel = TorchTransducer(input_dim=8, vocab_size=V, joint_dim=16, enc_dim=16,
                             enc_ff_dim=32, enc_attn_heads=2, enc_layers=1, dec_dim=16,
                             dec_units=16, dec_layers=1,
                             generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.normal(size=(2, 12, 8)).astype(np.float32))
    xlens = torch.tensor([12, 12])  # T' = 2 frames: 16 paths
    beam = tdecode.transducer_beam_search(tmodel, xs, xlens, beam_size=16,
                                          expansions_per_frame=1)
    with torch.no_grad():
        h_enc, _ = tmodel.encode(xs, xlens)
        for b in range(2):
            assert beam[b] == _exhaustive_best(tmodel, h_enc[b], V), b


def test_decode_utterance_and_task_inference_dispatch(pair, tiny_corpus, tmp_path):
    from liteasr_tpu_torch.tasks.asr import ASRTask

    _, _, tmodel = pair
    xs, xlens, _, _ = td_batch(10)
    x = xs[1, :xlens[1]]
    hyp = tdecode.decode_utterance(tmodel, x, beam_size=4)
    assert hyp == tdecode.transducer_beam_search(tmodel, t(x[None]), t([len(x)]),
                                                 beam_size=4)[0]
    task = ASRTask(DotDict(vocab=str(tiny_corpus / "vocab.txt"), delimiter=None,
                           save_dir=str(tmp_path)))
    assert task.inference(x, tmodel) == task.ids_to_text(
        tdecode.decode_utterance(tmodel, x))
    with pytest.raises(NotImplementedError, match="decoding families"):
        tdecode.decode_utterance(torch.nn.Linear(2, 2), x)
