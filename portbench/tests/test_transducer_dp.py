"""CPU rehearsals of the transducer and data-parallel drivers at a tiny size,
in fresh interpreters: ``train_rnnt`` is correct, its lattice counter reads
B x T' x (U+1) x V of the traced batches, and each fault and the fp8
control is not correct; ``train_dp`` over 2 gloo ranks equals one process
on the global batch (the reference's) to fp32 rounding, and a broken step
is not correct."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

RNNT = "conformer_rnnt.train_aishell_38k"
DP = "u2_conformer.train_dp4"
# each workload's (configuration, traffic mix) files, its tiny widths and its ranks
CELLS = {
    RNNT: ("conformer_rnnt", "aishell_rnnt_38k", 1,
           dict(enc_dim=32, enc_ff_dim=64, enc_layers=2, dec_dim=16, dec_units=24,
                joint_dim=20, vocab_size=40)),
    DP: ("u2_conformer", "aishell_train_25k_dp4", 2,
         dict(enc_dim=32, dec_dim=32, enc_ff_dim=64, dec_ff_dim=64, enc_layers=2,
              dec_layers=1, vocab_size=40)),
}
TRAFFIC = {"utterances": 24, "port": ["dataset.max_frame_in=3000"], "trace_steps": 2,
           "seconds": {"median": 1.0, "sigma": 0.3, "min": 0.5, "max": 2.0}}

REHEARSE = textwrap.dedent("""
    import json, sys, time
    sys.path[:0] = [{bench!r}, {root!r}]
    import torch, harness
    t0 = time.perf_counter()
    here = harness.HERE
    name, config, mix, chips, tiny = {workload!r}, {config!r}, {mix!r}, {chips!r}, {tiny!r}
    cell = harness.Cell(name=name, config_name=config, traffic_name=mix, chips=chips,
                        config=harness.load_json(here / "configs" / f"{{config}}.json"),
                        traffic=harness.load_json(here / "traffic" / f"{{mix}}.json"),
                        limits=harness.load_json(here / "limits" / f"{{name}}.json"))
    cell.config["model"].update(tiny)
    # fp32 at this size: the program and the reference agree to rounding
    for overrides in cell.config["port"].values():
        overrides.append("model.dtype=float32")
    cell.traffic.update({traffic!r})
    cell.seed, cell.seconds, cell.trace = {seed!r}, 1.5, True
    cell.device, cell.t_start, cell.control = torch.device("cpu"), t0, {control!r}
    driver = harness.load_module("drivers", cell.traffic["driver"])
    cells = []
    if hasattr(driver, "TransducerFamily"):  # the traced batches' lattices
        bound = driver.TransducerFamily.attn_bound_s

        def attn_bound_s(self, batch):
            B, T = batch["xs"].shape[:2]
            cells.append(B * (((T - 1) // 2 - 1) // 2) * (batch["ys"].shape[1] + 1)
                         * self.m["vocab_size"])
            return bound(self, batch)

        driver.TransducerFamily.attn_bound_s = attn_bound_s
    run = driver.run(cell)
    line = harness.result_line(cell, run, {{}})
    print(json.dumps({{"correct": run.correct, "attempted": run.attempted,
                      "failed": run.failed, "checks": run.checks, "metrics": run.metrics,
                      "per_layer": line["metrics"], "traced_cells": cells,
                      "forbidden": harness.forbidden_loaded()}}))
""")


def rehearse(workload: str, control: str = "", seed: int = 2 ** 31 + 11):
    config, mix, chips, tiny = CELLS[workload]
    src = REHEARSE.format(bench=str(BENCH), root=str(ROOT), workload=workload, config=config,
                          mix=mix, chips=chips, tiny=tiny, traffic=TRAFFIC, seed=seed,
                          control=control)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_transducer_rehearsal_is_correct_and_counts_its_lattices():
    out = rehearse(RNNT)
    assert out["forbidden"] == []
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["train_audio_s_per_s"] > 0
    per_layer = out["per_layer"]
    cells = out["traced_cells"]
    assert len(cells) == TRAFFIC["trace_steps"]
    assert per_layer["train.rnnt_lattice_mcells"]["value"] == pytest.approx(
        sum(cells) / len(cells) / 1e6)
    assert per_layer["train.rnnt_dp_host_ms"]["value"] > 0
    # the stream times exist on a CUDA device only
    assert "train.rnnt_joint_device_ms" not in per_layer


@pytest.mark.parametrize("control", ["control", "state_unchanged", "half_batch"])
def test_a_broken_transducer_step_or_the_control_is_not_correct(control):
    out = rehearse(RNNT, control)
    assert not out["correct"], out["checks"]


def test_dp_rehearsal_equals_one_process_on_the_global_batch():
    out = rehearse(DP)
    assert out["forbidden"] == []
    assert out["correct"], out["checks"]
    gaps = {c["name"]: c["value"] for c in out["checks"]}
    # two gloo ranks' summed loss, first gradient and update against the
    # reference's one process, to fp32 rounding
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["train_audio_s_per_s"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_dp_step_is_not_correct(fault):
    out = rehearse(DP, fault)
    assert not out["correct"], out["checks"]
