"""liteasr_tpu_torch, training, transducer, streaming, Paraformer, wav2vec 2.0,
native, data-parallel, export, prompt, Kaldi helper and recipe (tools)
modules included, imports without jax, flax or liteasr_tpu; registering
K1's custom op builds no kernel; and its CUDA kernel loader raises (no
fallback) where there is no CUDA device."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_without_jax():
    proc = _run("""
        import importlib, pkgutil, sys
        import liteasr_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            liteasr_tpu_torch.__path__, "liteasr_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "liteasr_tpu"))
        assert not bad, bad
        for name in ("ops.flash_attention", "ops.batch_norm", "ops.ctc",
                     "criterions.hybrid_ctc_attn", "optims.fused_step",
                     "optims.noam", "optims.adam", "trainer", "train",
                     "utils.trigger", "data.loader", "models.transducer",
                     "nets.rnn_decoder", "ops.rnnt", "criterions.rnnt",
                     "streaming", "native", "nets.paraformer", "models.paraformer",
                     "criterions.paraformer_loss", "nets.wav2vec2",
                     "models.wav2vec2", "criterions.wav2vec_loss", "tasks.pretrain",
                     "ops.masks", "parallel", "parallel.mesh", "tasks.synthetic",
                     "export", "prompt", "data.kaldi_helpers", "tools",
                     "tools.make_synth_corpus", "tools.make_synth_waves",
                     "tools.score_ci", "tools.summarize_run", "tools.run_hard",
                     "tools.eval_hard", "utils.tracing"):
            assert "liteasr_tpu_torch." + name in names, (name, names)
        # K1's custom op is registered, and registering it loaded no kernel
        import torch
        from liteasr_tpu_torch.ops import flash_attention as fa
        assert torch.ops.liteasr.rel_attention_fwd.default is not None
        assert not fa._LIBS
        print(len(names))
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 75  # 68 before the 7 tools modules


def test_kernel_loader_raises_without_cuda():
    proc = _run("""
        from liteasr_tpu_torch.ops import flash_attention as fa
        for name in fa.SOURCES:
            try:
                fa.load_library(name)
            except RuntimeError as e:
                print("raised:", e)
            else:
                raise SystemExit(f"the loader returned {name} without a CUDA device")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("raised: CUDA is not available") == 3
