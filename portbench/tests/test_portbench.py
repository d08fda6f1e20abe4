"""CPU tests of the benchmark: its files resolve by name, a new cell and
metric are new files only, the yardstick's arithmetic holds its pinned
values, a rehearsal of each driver at a tiny size runs without JAX and
comes out correct, and the planted faults and the control come out not
correct. The card's own test (``gpu``) runs one short cell."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import flops  # noqa: E402
import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TINY_MODEL = dict(enc_dim=32, dec_dim=32, enc_ff_dim=64, dec_ff_dim=64, enc_layers=2,
                  dec_layers=1, vocab_size=40)


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_by_name():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    used = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = harness.load_cell(w["name"])
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert cell.limits
        used.add(w["config"])
        reported = harness.per_layer_metrics(cell)
        assert reported, w["name"]
        for m in reported:
            assert callable(harness.load_module("metrics", m["name"]).read)
    assert used == {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def _digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / BENCH.name)
    here = tmp_path / BENCH.name
    mix = json.loads((here / "traffic" / "aishell_train_25k.json").read_text())
    mix["port"] = ["dataset.max_frame_in=51200"]
    (here / "traffic" / "aishell_train_51k.json").write_text(json.dumps(mix))
    (here / "limits" / "u2_conformer.train_aishell_51k.json").write_text(
        (here / "limits" / "u2_conformer.train_aishell_25k.json").read_text())
    (here / "metrics" / "train.steps_read.py").write_text(
        "def read(run):\n    return run.stats.get('steps')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "u2_conformer.train_aishell_51k",
                               "config": "u2_conformer", "traffic": "aishell_train_51k",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "train.steps_read", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step", "moves": "train_audio_s_per_s",
                               "workloads": ["u2_conformer.train_aishell_51k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("u2_conformer.train_aishell_51k", root=tmp_path)
    assert cell.traffic["port"] == ["dataset.max_frame_in=51200"]
    names = [m["name"] for m in harness.per_layer_metrics(cell, root=tmp_path)]
    assert "train.steps_read" in names
    run = harness.Run(stats={"steps": 7, "kind": "later"},
                      checks=[{"name": "loss_gap", "value": 0.0, "limit": 1.0}])
    cell.trace = True
    line = harness.result_line(cell, run, {}, root=tmp_path)
    assert line["metrics"]["train.steps_read"]["value"] == 7.0
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_flop_counts_keep_the_recorded_values():
    # PERF.md: 1.939 TFLOP a U2 micro-step at 32 x 800 frames, 48 labels,
    # vocab 5000; 3.619 TFLOP a wav2vec 2.0 BASE micro-step at 24 x 56,000
    assert flops.u2_train_flops([(800, 48)] * 32, 5000) == pytest.approx(1.939e12, rel=5e-4)
    assert flops.w2v2_train_flops(24, 56_000) == pytest.approx(3.619e12, rel=5e-4)
    # BASE's final_dim 256 narrows the final and quantizer projections, the
    # codebook (128 a group) and the 101 candidates' products
    n, d = 24 * 174, 768
    narrower = 3 * 2.0 * n * (d * 512 + 320 * 512 + (768 ** 2 - 256 ** 2) + 101 * 512)
    assert (flops.w2v2_train_flops(24, 56_000) - flops.w2v2_train_flops(24, 56_000, final_dim=256)
            == pytest.approx(narrower))


def test_roofline_and_idle_arithmetic_on_a_synthetic_trace():
    events = [
        ("portbench.train_step", False, 0.0, 10.0),
        ("portbench.train_step", True, 0.0, 10.0),
        ("aten::mm", False, 1.0, 2.0),
        ("aten::add", False, 5.5, 6.5),
        ("rel_attn_fwd_tc_kernel", True, 1.0, 3.0),
        ("gemm", True, 2.0, 4.0),
        ("rel_attn_bwd_tc_kernel", True, 6.0, 7.0),
        ("Memcpy HtoD", True, 8.0, 8.5),
    ]
    red = harness.reduce_trace(events, window_s=10.0, steps=2)
    assert red["busy_s"] == pytest.approx(3.0 + 1.0 + 0.5)
    assert red["kernels"] == 3
    # device idle from 4 to 6 (the host in aten::add from 5.5) and 7 to 8
    idle = dict((n, s) for n, s in red["idle_gaps"])
    assert idle == {"portbench.train_step": pytest.approx(3.0)}
    red["attn_bound_s"] = 1.5
    red["attn_kernels"] = ("rel_attn_fwd", "rel_attn_bwd", "bwd_prep_kernel")
    run = harness.Run(stats={"kind": "train"}, trace=red)
    roof = harness.load_module("metrics", "attn_roofline_pct.train").read(run)
    assert roof == pytest.approx(100.0 * 1.5 / 3.0)
    idle_pct = harness.load_module("metrics", "device_idle_pct.train").read(run)
    assert idle_pct == pytest.approx(55.0)
    assert harness.load_module("metrics", "train.kernels_per_step").read(run) == 1.5
    # least time of one K1' call: bytes-bound at these sizes
    t = flops.fwd_bound(8, 100, 100, 64, [100] * 8, lse=True, heads=4)
    reads = (2 * 8 * 100 * 64 + 4 * 100 * 64 + 2 * 8 * 100 * 64) * 2 + 4 * 8
    writes = 8 * 100 * 64 * 2 + 4 * 8 * 100
    assert t == pytest.approx((reads + writes) / flops.HBM_BYTES_PER_S)


def _imports(path: Path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def _forbidden_imports(path: Path):
    return [n for n in _imports(path) if n.partition(".")[0] in
            ("liteasr_tpu_torch", "liteasr_tpu", "jax", "jaxlib", "flax", "bench")]


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert _forbidden_imports(path) == [], path.name
    for path in sorted(BENCH.rglob("*.py")):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        bad = [n for n in _forbidden_imports(path) if n.partition(".")[0] != "liteasr_tpu_torch"]
        assert bad == [], path
        assert "tools" not in [n.partition(".")[0] for n in _imports(path)], path


REHEARSE = textwrap.dedent("""
    import json, sys, time
    sys.path[:0] = [{bench!r}, {root!r}]
    import torch, harness
    t0 = time.perf_counter()
    here = harness.HERE
    config, mix = {files!r}
    cell = harness.Cell(name={workload!r}, config_name=config, traffic_name=mix, chips=1,
                        config=harness.load_json(here / "configs" / f"{{config}}.json"),
                        traffic=harness.load_json(here / "traffic" / f"{{mix}}.json"),
                        limits=harness.load_json(here / "limits" / ({workload!r} + ".json")))
    cell.config["model"].update({tiny!r})
    # fp32 at this size: the program and the reference agree to rounding,
    # and the checks' limits separate them from the fp8 control and the faults
    for overrides in cell.config["port"].values():
        overrides.append("model.dtype=float32")
    cell.traffic.update({traffic!r})
    cell.seed, cell.seconds, cell.trace = {seed!r}, 1.5, True
    cell.device, cell.t_start, cell.control = torch.device("cpu"), t0, {control!r}
    run = harness.load_module("drivers", cell.traffic["driver"]).run(cell)
    print(json.dumps({{"correct": run.correct, "attempted": run.attempted,
                      "failed": run.failed, "checks": run.checks,
                      "metrics": run.metrics, "forbidden": harness.forbidden_loaded()}}))
""")

TINY_TRAFFIC = {"utterances": 24, "port": ["dataset.max_frame_in=3000"], "trace_steps": 2,
                "seconds": {"median": 1.0, "sigma": 0.3, "min": 0.5, "max": 2.0}}


def rehearse(workload: str, control: str = "", seed: int = 2 ** 31 + 11, cwd=ROOT,
             bench=BENCH, root=ROOT, model=TINY_MODEL, traffic=TINY_TRAFFIC):
    """One run of ``workload``'s driver on the CPU at a tiny size, in a
    fresh interpreter (so that ``sys.modules`` is the run's own)."""
    src = REHEARSE.format(bench=str(bench), root=str(root), workload=workload,
                          files=FILES[workload], tiny=model, traffic=traffic, seed=seed,
                          control=control)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=600)
    return proc


TRAIN = "u2_conformer.train_aishell_25k"
PRETRAIN = "w2v2_base.pretrain_librispeech"
# each rehearsed workload's (configuration, traffic mix) files
FILES = {TRAIN: ("u2_conformer", "aishell_train_25k"),
         PRETRAIN: ("w2v2_base", "librispeech_pretrain")}


def test_train_rehearsal_is_correct_and_loads_no_jax():
    proc = rehearse(TRAIN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["train_audio_s_per_s"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault):
    proc = rehearse(TRAIN, control=fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]


def test_the_lower_precision_control_is_not_correct():
    proc = rehearse(TRAIN, control="control")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]


TINY_W2V = dict(conv_feature_layers="[(32, 10, 5)] + [(32, 3, 2)] * 2", encoder_layers=1,
                encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=2,
                conv_pos=8, conv_pos_groups=2, latent_vars=16, num_negatives=4, final_dim=16)
# six waves make one batch of six rows, so that half of it left out shows
TINY_WAVES = dict(TINY_TRAFFIC, utterances=6)


def test_pretrain_rehearsal_is_correct_and_loads_no_jax():
    proc = rehearse(PRETRAIN, model=TINY_W2V, traffic=TINY_WAVES)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"], out["checks"]
    # the codebook perplexity is compared beside the step's norms
    assert "code_ppl_gap" in {c["name"] for c in out["checks"]}
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_pretrain_step_is_not_correct(fault):
    proc = rehearse(PRETRAIN, control=fault, model=TINY_W2V, traffic=TINY_WAVES)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", TRAIN,
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = rehearse(TRAIN, cwd=tmp_path, bench=tmp_path / BENCH.name, root=tmp_path)
    assert proc.returncode != 0
    assert "liteasr_tpu_torch" in proc.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _card_run(workload: str, control: str = ""):
    args = [sys.executable, "portbench/run.py", "--workload", workload,
            "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"]
    proc = subprocess.run(args + (["--control", control] if control else []),
                          capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_the_control_is_not_correct_at_the_cells_size(card, workload):
    """The reference in fp8 in the program's place, at the cell's own size."""
    line = _card_run(workload, "control")
    assert not line["correct"], line["checks"]


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    line = _card_run(TRAIN)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"

