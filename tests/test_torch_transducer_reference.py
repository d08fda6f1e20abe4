"""The port's conformer transducer against the benchmark's plain reference
(``portbench/reference/transducer.py``), without JAX: on the CPU in fp32
at tiny widths, from the benchmark's seeded weights, the port's train-mode
loss (``model=my_transducer`` with a conformer encoder, swish and rel-pos
attention, built by ``task.build_model``; the ``my_rnnt`` criterion) and
every gradient leaf equal the reference's, with dropout off and with the
benchmark's dropout masks, the reference's lattice whole and in blocks of
one row. The reference's forward variable over the anti-diagonals equals
the exhaustive sum over every alignment at T' <= 4, U <= 3."""

import itertools
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 19
M = dict(input_dim=16, vocab_size=12, enc_arch="conformer", activation="swish",
         use_rel=True, enc_dim=32, enc_ff_dim=64, enc_attn_heads=4, enc_layers=2,
         conv_kernel=15, dec_dim=16, dec_units=20, dec_layers=2, joint_dim=24,
         enc_attn_dropout_rate=0.0)
RATES = ("dropout_rate", "enc_dropout_rate", "enc_pos_dropout_rate", "enc_ff_dropout_rate",
         "dec_dropout_rate")


def _bench():
    """The benchmark's weights, draws and transducer reference."""
    sys.path[:0] = [str(ROOT / "portbench")]
    try:
        import weights
        from reference import draws, transducer, u2

        return weights, draws, transducer, u2
    finally:
        del sys.path[0]


def _port(m):
    """The port's model and criterion from the composed config, as the train
    CLI builds them."""
    from liteasr_tpu_torch import tasks
    from liteasr_tpu_torch.config import compose

    keys = [k for k in m if k not in ("input_dim", "vocab_size", "conv_kernel")]
    cfg = compose(["task=synthetic", "model=my_transducer", "criterion=my_rnnt",
                   f"task.vocab_size={m['vocab_size']}", f"task.feat_dim={m['input_dim']}"]
                  + [f"model.{k}={m[k]}" for k in keys])
    task = tasks.setup_task(cfg.task)
    model = task.build_model(cfg.model, device=CPU, generator=torch.Generator())
    return model, task.build_criterion(cfg.criterion)


def _batch():
    """Ragged rows: full, shorter, a 19-frame row (T' = 3) of one label."""
    g = torch.Generator().manual_seed(5)
    B, T, U = 3, 57, 6
    ys = torch.randint(1, M["vocab_size"], (B, U), generator=g)
    ylens = torch.tensor([6, 3, 1])
    ys[torch.arange(U)[None, :] >= ylens[:, None]] = -1
    return {"xs": torch.randn(B, T, M["input_dim"], generator=g),
            "xlens": torch.tensor([57, 44, 19]), "ys": ys, "ylens": ylens,
            "valid": torch.ones(B)}


@pytest.mark.parametrize("cells", [None, 1], ids=["whole", "row_blocks"])
@pytest.mark.parametrize("dropout", ["off", "masks"])
def test_port_train_step_equals_the_reference(dropout, cells, monkeypatch):
    weights, draws, transducer, u2 = _bench()
    m = dict(M, **{k: (0.1 if dropout == "masks" else 0.0) for k in RATES})
    model, criterion = _port(m)
    lay = transducer.layout(m)
    named = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in named.items()} == {n: s for n, s, _ in lay}
    init = weights.draw(lay, SEED, CPU)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(init[n])
    batch = _batch()

    monkeypatch.setattr(torch.nn.functional, "dropout", draws.Dropouts(SEED, 0, CPU))
    loss, _ = criterion(model, dict(batch), train=True)
    loss.backward()
    P = {n: t.clone().requires_grad_(True) for n, t in init.items()}
    ref = transducer.TransducerReference(m, u2.Ops("fp32"))
    ref_loss, grads = ref.loss_and_grads(P, dict(batch), draws.Dropouts(SEED, 0, CPU),
                                         draws.SeedStream(SEED), cells)

    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    assert set(grads) == set(named)
    for n, p in named.items():
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-4, atol=1e-5, msg=n)


def _alignments_nll(logp, targets, T, U):
    """-log of the sum over every path from (0, 0) to (T-1, U) of T-1 blanks
    and U emissions in any order, closed by the blank at (T-1, U)."""
    paths = []
    for emits in itertools.combinations(range(T - 1 + U), U):
        t = u = 0
        score = logp.new_zeros(())
        for k in range(T - 1 + U):
            if k in emits:
                score = score + logp[t, u, targets[u]]
                u += 1
            else:
                score = score + logp[t, u, 0]
                t += 1
        paths.append(score + logp[t, u, 0])
    return -torch.logsumexp(torch.stack(paths), dim=0)


@pytest.mark.parametrize("T,U", [(1, 0), (1, 3), (2, 1), (3, 2), (4, 0), (4, 3)])
def test_reference_dp_is_the_sum_over_alignments(T, U):
    _, _, transducer, _ = _bench()
    g = torch.Generator().manual_seed(10 * T + U)
    B, V = 3, 5
    logp = torch.log_softmax(torch.randn(B, 4, 4, V, dtype=torch.float64, generator=g), -1)
    targets = torch.randint(1, V, (B, 3), generator=g)
    # every row is cut to (T, U) inside a padded (4, 3 + 1) lattice
    t_len, u_len = torch.full((B,), T), torch.full((B,), U)
    emit = torch.gather(logp[:, :, :3], 3, targets[:, None, :, None].expand(B, 4, 3, 1))[..., 0]
    got = transducer.rnnt_nll(logp[..., 0], emit, t_len, u_len)
    want = torch.stack([_alignments_nll(logp[b], targets[b], T, U) for b in range(B)])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
