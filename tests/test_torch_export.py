"""The port's export (``liteasr_tpu_torch/export.py``): ``torch.export``
programs of the decode pipeline and the forward, against the live ones
(tests/test_export.py's cases on the port).

* An ``attention_rescore`` program at a fixed bucket, saved to bytes and
  loaded, gives the live pipeline's tokens and lengths exactly; run with a
  second set of weights, without a new export, it gives the live pipeline's
  at those weights; its graph holds one ``liteasr::rel_attention_fwd`` node
  for each K1 call of the pipeline; moved to another device on load it runs
  there.
* The exported forward is within 1e-6 of the live one.
* The CLI over a config dir and a checkpoint writes the program and its
  manifest (the JAX keys), probing ``input_dim`` from the test set.
* The live pipeline's hypotheses equal the JAX package's ``_get_pipeline``
  on the same weights (through ``bridge.py``).
* On the card (marker ``gpu``): the loaded program launches the CUDA K1,
  once per K1 node, and equals the live pipeline.

JAX is imported inside the one test that needs it, so that the card, which
has no JAX, runs the ``gpu`` case (``pytest --noconftest -m gpu``).
"""

import json

import numpy as np
import pytest
import torch

from liteasr_tpu_torch import decode, export
from liteasr_tpu_torch.ops import flash_attention as fa

TINY = dict(input_dim=8, vocab_size=12, enc_layers=2, dec_layers=1, enc_dim=16,
            enc_ff_dim=32, dec_dim=16, dec_ff_dim=32, enc_attn_heads=2, dec_attn_heads=2)
B, T, U = 2, 32, 4
BEAM = 3


def _u2(seed):
    from liteasr_tpu_torch.models.u2 import U2

    return U2(**TINY, generator=torch.Generator().manual_seed(seed)).eval()


def _batch(device="cpu"):
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(B, T, 8)).astype(np.float32)).to(device)
    return xs, torch.tensor([T, T - 11], device=device)


def _live(model, xs, xlens):
    with torch.inference_mode():
        return decode.decode_pipeline(model, "attention_rescore", BEAM, 0.5)(xs, xlens)


@pytest.fixture(scope="module")
def rescore():
    model = _u2(0)
    blob = export.export_decode(model, model.state_dict(), mode="attention_rescore",
                                beam_size=BEAM, ctc_weight=0.5, batch=B, frames=T,
                                feat_dim=8, platforms="cpu")
    return model, blob


def test_export_decode_roundtrip(rescore):
    model, blob = rescore
    assert isinstance(blob, bytes) and len(blob) > 0
    xs, xlens = _batch()
    want = _live(model, xs, xlens)
    got = export.load_exported(blob)(model.state_dict(), xs, xlens)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert decode.hypotheses(model, "attention_rescore", got) == decode.decode_batch(
        model, xs, xlens, BEAM, 0.5, "attention_rescore")


def test_other_weights_need_no_new_export(rescore):
    """The artifact holds the program, not the weights: its data files are
    a few bytes of constants, against the model's ~0.1 MB of weights."""
    import io
    import zipfile

    _, blob = rescore
    data = sum(i.file_size for i in zipfile.ZipFile(io.BytesIO(blob)).infolist()
               if "/data/" in i.filename)
    assert data < 1024
    other = _u2(1)
    xs, xlens = _batch()
    want = _live(other, xs, xlens)
    got = export.load_exported(blob)(other.state_dict(), xs, xlens)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert not torch.equal(got[0], _live(_u2(0), xs, xlens)[0])  # the weights matter


def test_graph_has_a_k1_node_per_k1_call(rescore, monkeypatch):
    model, blob = rescore
    calls = []
    plain = fa.flash_attention_plain

    def count(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_plain", count)
    _live(model, *_batch())
    # the encoder's layers, the decoder's self and source attention
    assert len(calls) == TINY["enc_layers"] + 2 * TINY["dec_layers"]
    assert export.count_nodes(blob) == len(calls)
    assert export.count_nodes(export.load_exported(blob).program) == len(calls)


def test_export_forward_roundtrip():
    model = _u2(0)
    xs, xlens = _batch()
    ys = torch.ones((B, U), dtype=torch.int64)
    ylens = torch.full((B,), U, dtype=torch.int64)
    blob = export.export_forward(model, model.state_dict(), batch=B, frames=T, feat_dim=8,
                                 label_len=U, platforms="cpu")
    with torch.no_grad():
        h_attn, h_ctc = model(xs, xlens, ys, ylens, train=False)
    g_attn, g_ctc = export.load_exported(blob)(model.state_dict(), xs, xlens, ys, ylens)
    torch.testing.assert_close(g_attn, h_attn, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g_ctc, h_ctc, rtol=1e-6, atol=1e-6)


def test_platforms():
    assert export._device("cpu") == torch.device("cpu")
    assert export._device(("gpu",)) == export._device("cuda") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="traced on one device"):
        export._device(("tpu", "cpu"))
    with pytest.raises(ValueError, match="unknown platform"):
        export._device("tpu")


def test_export_cli(tiny_corpus, tmp_path):
    """python -m liteasr_tpu_torch.export --config-dir <run>: builds the
    model from the persisted run config (probing input_dim from the test
    set, like the infer CLI), loads the checkpoint, writes the program and
    its manifest; the program decodes as the live pipeline of the
    checkpoint."""
    from liteasr_tpu_torch import tasks
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import to_yaml

    cfg = compose([
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_noam",
        f"task.vocab={tiny_corpus / 'vocab.txt'}", f"task.train={tiny_corpus / 'train'}",
        f"task.valid={tiny_corpus / 'valid'}", f"task.test=[{tiny_corpus / 'test'}]",
        f"task.save_dir={tmp_path / 'ckpts'}", f"common.run_dir={tmp_path}",
        "model.enc_layers=1", "model.dec_layers=1", "model.enc_dim=32",
        "model.enc_ff_dim=64", "model.dec_dim=32", "model.dec_ff_dim=64",
        "model.enc_attn_heads=2", "model.dec_attn_heads=2"])
    (tmp_path / "config.yaml").write_text(to_yaml(cfg))
    task = tasks.setup_task(cfg.task)
    task.load_dataset("test", list(task.cfg.test), cfg.dataset, None)
    cfg.model.input_dim = task.feat_dim
    model = task.build_model(cfg.model, generator=torch.Generator().manual_seed(3)).eval()
    (tmp_path / "ckpts").mkdir(exist_ok=True)
    torch.save(model.state_dict(), tmp_path / "ckpts" / "model.ep.1.pt")

    out = tmp_path / "rescore.pt2"
    got = export.main(["--config-dir", str(tmp_path), "inference.ckpt_name=1",
                       "inference.model_avg=false", f"export.out={out}",
                       "export.mode=attention_rescore", "export.batch=2",
                       "export.frames=40", "export.platforms=cpu"])
    assert got == str(out) and out.is_file()
    manifest = json.loads((tmp_path / "rescore.pt2.json").read_text())
    assert manifest == {"mode": "attention_rescore", "batch": 2, "frames": 40,
                        "feat_dim": task.feat_dim, "bytes": out.stat().st_size}
    assert (tmp_path / "export.log").is_file()
    xs = torch.randn(2, 40, task.feat_dim, generator=torch.Generator().manual_seed(4))
    xlens = torch.tensor([40, 29])
    run = export.load_exported(out.read_bytes())
    with torch.inference_mode():
        want = decode.decode_pipeline(model, "attention_rescore")(xs, xlens)
    for w, g in zip(want, run(model.state_dict(), xs, xlens)):
        assert torch.equal(w, g)


def test_live_pipeline_matches_jax():
    """The port's pipeline on a JAX init (bridged) decodes the hypotheses of
    JAX's jitted ``_get_pipeline``, in each of the pipeline's modes."""
    import jax
    import jax.numpy as jnp

    from liteasr_tpu.config.core import DotDict, _node_to_dict
    from liteasr_tpu.decode import _get_pipeline
    from liteasr_tpu.models.u2 import U2 as JaxU2, U2Config
    from liteasr_tpu_torch.bridge import flax_to_state_dict

    cfg = DotDict(_node_to_dict(U2Config))
    cfg.update(dict(TINY, dropout_rate=0.0))
    for k in list(cfg):
        if isinstance(cfg[k], str) and cfg[k].startswith("${"):
            cfg[k] = 0.0
    jmodel = JaxU2.build_model(cfg, None)
    xs, xlens = _batch()
    jxs, jxlens = jnp.asarray(xs.numpy()), jnp.asarray(xlens.numpy(), jnp.int32)
    variables = jax.device_get(jax.jit(lambda k: jmodel.init(
        {"params": k}, jxs, jxlens, jnp.ones((B, U), jnp.int32),
        jnp.full((B,), U, jnp.int32), train=False))(jax.random.PRNGKey(0)))
    model = _u2(0)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    for mode in ("attention_rescore", "ctc_prefix_beam_search", "ctc_greedy"):
        jout = _get_pipeline(jmodel, mode, BEAM, 0.5)(variables, jxs, jxlens)
        with torch.inference_mode():
            out = decode.decode_pipeline(model, mode, BEAM, 0.5)(xs, xlens)
        for w, g in zip(jout, out):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=mode)


@pytest.mark.gpu
def test_loaded_program_launches_k1_on_the_card(rescore):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    model, blob = rescore
    dev = torch.device("cuda", 0)
    run = export.load_exported(blob, device=dev)  # traced on the CPU, moved
    model = model.to(dev)
    state = model.state_dict()
    xs, xlens = _batch(dev)
    fa.flash_attention.launches = 0
    got = run(state, xs, xlens)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == export.count_nodes(blob)
    want = _live(model, xs, xlens)
    for w, g in zip(want, got):
        assert g.device.type == "cuda" and torch.equal(w, g)
