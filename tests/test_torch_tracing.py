"""The port's spans (``liteasr_tpu_torch.utils.tracing``), without JAX (so
the card, which has no JAX, runs the ``gpu`` case with ``python -m pytest
--noconftest -m gpu tests/test_torch_tracing.py``).

On the CPU: with no profiler a tiny U2 micro-step records nothing and a
span is the shared no-op; under a profiler two micro-steps record each
span twice with its parent and micro-step, the collation from the
loader's worker; a span's stamps bracket the profiler's own event of an op
inside it, and no span reaches the profiler's events; the benchmark's
twelve readers of the spans read nothing without them and the per-micro-step
values of a hand-built table; a transducer's forward records its four
spans, its lattice counter, its DP's row counter and its LayerNorms'
rows once, only under a profiler, and the benchmark's reader of the
lattice counter; the CPU's
DP counts its rows as the plain loop's; a ``common.profile_dir`` run's
trace carries the spans as rows of their own, on the trace's time base.
``to_device``
gives the same tensors whether a batch carries page-locked copies or not,
and its byte counters record each copy, as pageable on the CPU, only under
a profiler; the benchmark's reader of their share. On the card: no
device event carries a span's name, and the three phases' stream times are
positive and add up to no more than the traced wall.
"""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from liteasr_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("train.forward", "train.backward", "train.optimizer")
NAMES = ("train.step",) + PHASES + ("data.wait", "data.collate", "data.to_device")
COUNTERS = ("data.h2d_pinned_bytes", "data.h2d_pageable_bytes")
IDS = ("ys", "xlens", "ylens")
# each reader of the benchmark: (span, key, divided by the micro-steps)
READERS = {
    "train.batch_wait_ms": ("data.wait", "host_ms", True),
    "train.collate_ms": ("data.collate", "host_ms", False),
    "train.h2d_ms": ("data.to_device", "host_ms", True),
    "train.forward_host_ms": ("train.forward", "host_ms", True),
    "train.forward_device_ms": ("train.forward", "device_ms", True),
    "train.backward_host_ms": ("train.backward", "host_ms", True),
    "train.backward_device_ms": ("train.backward", "device_ms", True),
    "train.optimizer_host_ms": ("train.optimizer", "host_ms", True),
    "train.optimizer_device_ms": ("train.optimizer", "device_ms", True),
    "train.rnnt_joint_device_ms": ("rnnt.joint", "device_ms", True),
    "train.rnnt_lattice_device_ms": ("rnnt.lattice", "device_ms", True),
    "train.rnnt_dp_host_ms": ("rnnt.dp", "host_ms", True),
}
RNNT = ("rnnt.predictor", "rnnt.joint", "rnnt.lattice", "rnnt.dp")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny Kaldi-format corpus written by the port's own ``kaldi_io``."""
    from liteasr_tpu_torch.data import kaldi_io

    root = tmp_path_factory.mktemp("tracing_corpus")
    rng = np.random.default_rng(7)
    tokens = ["<unk>"] + [chr(ord("a") + i) for i in range(26)]
    (root / "vocab.txt").write_text("".join(f"{t} {i + 1}\n" for i, t in enumerate(tokens)))
    for split, n in (("train", 12), ("valid", 4)):
        d = root / split
        d.mkdir()
        mats, texts, frames = {}, [], []
        for i in range(n):
            uttid = f"{split}_{i:03d}"
            t = int(rng.integers(20, 60))
            mats[uttid] = rng.normal(size=(t, 16)).astype(np.float32)
            texts.append(f"{uttid} " + "".join(
                chr(ord("a") + int(c)) for c in rng.integers(0, 26, int(rng.integers(3, 8)))))
            frames.append(f"{uttid} {t}")
        kaldi_io.save_ark(str(d / "feats.ark"), mats, scp_path=str(d / "feats.scp"))
        (d / "utt2num_frames").write_text("\n".join(frames) + "\n")
        (d / "text").write_text("\n".join(texts) + "\n")
    return root


def _overrides(corpus, out, *extra):
    return ["task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_noam",
            f"task.vocab={corpus / 'vocab.txt'}", f"task.train={corpus / 'train'}",
            f"task.valid={corpus / 'valid'}", f"task.save_dir={out / 'ckpts'}",
            f"common.run_dir={out}", "model.enc_layers=2", "model.dec_layers=1",
            "model.enc_dim=32", "model.enc_ff_dim=64", "model.dec_dim=32",
            "model.dec_ff_dim=64", "dataset.batch_size=4", "dataset.num_workers=2",
            "optimization.accum_grad=2", "optimizer.warmup=10", "common.trigger=[]",
            *extra]


def _trainer(corpus, out, device):
    """A tiny U2 ``Trainer`` built as the train CLI builds it, not run."""
    from liteasr_tpu_torch import tasks
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.trainer import Trainer

    cfg = compose(_overrides(corpus, out))
    torch.manual_seed(0)
    task = tasks.setup_task(cfg.task)
    task.load_dataset("train", task.cfg.train, cfg.dataset, cfg.postprocess)
    task.load_dataset("valid", task.cfg.valid, cfg.dataset, cfg.postprocess)
    model = task.build_model(cfg.model, device=device,
                             generator=torch.Generator().manual_seed(0))
    return Trainer(cfg, task, model, task.build_criterion(cfg.criterion),
                   task.build_optimizer(cfg.optimizer), device)


def _micro_steps(trainer, count):
    """``count`` micro-steps as a training loop takes them: a batch from
    the loader, its copy to the device, the step."""
    from liteasr_tpu_torch.trainer import to_device

    loader = iter(trainer.train_iter)
    try:
        for _ in range(count):
            trainer.train_step(to_device(next(loader), trainer.device))
    finally:
        loader.close()


def _event_names(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_no_profiler_records_nothing(corpus, tmp_path):
    tracing.reset()
    trainer = _trainer(corpus, tmp_path, torch.device("cpu"))
    _micro_steps(trainer, 2)
    assert trainer.step == 2
    assert tracing.totals() == {} and tracing.spans() == []
    assert tracing.span("train.step") is tracing.OFF
    assert tracing.span("data.wait", torch.device("cpu"), step=3) is tracing.OFF


def test_two_micro_steps_under_a_cpu_profiler(corpus, tmp_path):
    trainer = _trainer(corpus, tmp_path, torch.device("cpu"))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("train.step") is not tracing.OFF
        _micro_steps(trainer, 2)
    totals = tracing.totals()
    assert set(totals) == set(NAMES) | set(COUNTERS) | {"layer_norm.plain_rows"}
    # the CPU's LayerNorms took the plain version: 2 x 5 + 1 in the
    # encoder, 3 + 1 in the decoder, a micro-step
    assert totals["layer_norm.plain_rows"]["count"] == 2 * 15
    # the CPU has no page-locked memory: every batch crossed as pageable
    assert totals["data.h2d_pinned_bytes"] == {"count": 2, "total": 0}
    assert totals["data.h2d_pageable_bytes"]["count"] == 2
    assert totals["data.h2d_pageable_bytes"]["total"] > 0
    for name in NAMES:
        t = totals[name]
        assert t["count"] == 2, name
        assert 0 <= t["self_ms"] <= t["host_ms"], name
        assert t["device_ms"] is None, name  # no CUDA device
    assert totals["train.step"]["self_ms"] < totals["train.step"]["host_ms"]
    assert sum(totals[p]["host_ms"] for p in PHASES) <= totals["train.step"]["host_ms"]

    spans = tracing.spans()
    assert len(spans) == 2 * len(NAMES)
    main = threading.current_thread().name
    for s in spans:
        assert s.step in (0, 1), s
        assert s.start_ns <= s.end_ns
        assert s.parent == ("train.step" if s.name in PHASES else None), s
        # the collation ran on a loader worker; the consumer recorded it
        assert (s.thread != main) == (s.name == "data.collate"), s
    for k in (0, 1):
        step = {s.name: s for s in spans if s.step == k}
        assert set(step) == set(NAMES)
        outer = step["train.step"]
        for name in PHASES:  # each phase inside its micro-step, in order
            assert outer.start_ns <= step[name].start_ns <= step[name].end_ns <= outer.end_ns
        assert (step["train.forward"].end_ns <= step["train.backward"].start_ns
                and step["train.backward"].end_ns <= step["train.optimizer"].start_ns)
        # the batch is waited for and copied before its micro-step
        assert step["data.wait"].end_ns <= step["data.to_device"].start_ns
        assert step["data.to_device"].end_ns <= outer.start_ns
    # no span is mirrored into the profiler's events
    assert not set(NAMES) & _event_names(prof)


def test_span_stamps_bracket_the_profilers_event_of_an_op_inside():
    tracing.reset()
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("probe"):
            torch.mm(a, b)
    (probe,) = tracing.spans()
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    # the same clock: the profiler's event lies inside the span's stamps
    assert probe.start_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= probe.end_ns
    assert "probe" not in _event_names(prof)


def _reader(name):
    sys.path[:0] = [str(ROOT / "portbench")]
    try:
        import harness

        return harness, harness.load_module("metrics", name)
    finally:
        del sys.path[0]


@pytest.mark.parametrize("name", sorted(READERS))
def test_benchmark_reader_of_the_spans(name, monkeypatch):
    harness, reader = _reader(name)
    train = harness.Run(stats={"kind": "train"})
    tracing.reset()
    assert reader.read(train) is None  # an untraced run: no span

    span, key, per_step = READERS[name]
    table = {"train.step": {"count": 4, "host_ms": 800.0, "self_ms": 8.0, "device_ms": 600.0},
             "train.forward": {"count": 4, "host_ms": 300.0, "self_ms": 300.0,
                               "device_ms": 200.0},
             "train.backward": {"count": 4, "host_ms": 200.0, "self_ms": 200.0,
                                "device_ms": 320.0},
             "train.optimizer": {"count": 4, "host_ms": 40.0, "self_ms": 40.0,
                                 "device_ms": 60.0},
             "data.wait": {"count": 4, "host_ms": 20.0, "self_ms": 20.0, "device_ms": None},
             "data.collate": {"count": 5, "host_ms": 150.0, "self_ms": 150.0,
                              "device_ms": None},
             "data.to_device": {"count": 4, "host_ms": 12.0, "self_ms": 12.0,
                                "device_ms": 2.0},
             "rnnt.joint": {"count": 4, "host_ms": 6.0, "self_ms": 6.0, "device_ms": 36.0},
             "rnnt.lattice": {"count": 4, "host_ms": 2.0, "self_ms": 2.0, "device_ms": 52.0},
             "rnnt.dp": {"count": 4, "host_ms": 240.0, "self_ms": 240.0, "device_ms": 250.0}}
    monkeypatch.setattr(tracing, "totals", lambda: table)
    want = table[span][key] / (4 if per_step else table[span]["count"])
    assert reader.read(train) == pytest.approx(want)
    assert reader.read(harness.Run(stats={"kind": "decode"})) is None
    # spans of a run with no micro-step read nothing
    monkeypatch.setattr(tracing, "totals", lambda: {k: v for k, v in table.items()
                                                    if k != "train.step"})
    assert reader.read(train) is None
    # a device reader on the CPU, where no span has a stream time
    monkeypatch.setattr(tracing, "totals", lambda: {
        k: dict(v, device_ms=None) for k, v in table.items()})
    assert (reader.read(train) is None) == (key == "device_ms")


def _batch(seed):
    """A collated batch as the port's collator makes one: float features,
    int32 ids."""
    rng = np.random.default_rng(seed)
    return {"xs": rng.standard_normal((3, 8, 4)).astype(np.float32),
            "xlens": np.array([8, 5, 3], np.int32),
            "ys": rng.integers(0, 9, (3, 6)).astype(np.int32),
            "ylens": np.array([6, 2, 1], np.int32),
            "valid": np.array([1, 1, 0], np.float32)}


BATCH_BYTES = 3 * 8 * 4 * 4 + 3 * 8 + 3 * 6 * 8 + 3 * 8 + 3 * 4  # the ids as int64


def _carried(batch):
    """``batch`` as a loader with ``pin_memory`` hands it on, its copies in
    ordinary memory (the CPU has no page-locked memory)."""
    from liteasr_tpu_torch.data.loader import PinnedBatch, host_tensor

    carried = PinnedBatch(batch)
    carried.pinned = {k: host_tensor(k, v).clone() for k, v in batch.items()}
    return carried


def test_to_device_gives_the_same_tensors_on_either_path():
    from liteasr_tpu_torch.trainer import to_device

    cpu = torch.device("cpu")
    batch = _batch(3)
    carried = _carried(batch)
    plain, other = to_device(batch, cpu), to_device(carried, cpu)
    assert list(plain) == list(other) == list(batch)
    for key, val in batch.items():
        want = torch.int64 if key in IDS else torch.float32
        assert plain[key].dtype == other[key].dtype == want, key
        assert torch.equal(plain[key], other[key]), key
        assert np.array_equal(plain[key].numpy(), val), key
        assert other[key] is carried.pinned[key], key  # the carried copy is the source
    assert all(carried[k] is batch[k] for k in batch)


def test_copy_counters_record_each_copy_only_under_a_profiler():
    from liteasr_tpu_torch.trainer import to_device

    cpu = torch.device("cpu")
    tracing.reset()
    to_device(_batch(1), cpu)
    to_device(_carried(_batch(2)), cpu)
    assert tracing.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        to_device(_batch(1), cpu)
        to_device(_carried(_batch(2)), cpu)
    totals = tracing.totals()
    assert totals["data.h2d_pageable_bytes"] == {"count": 2, "total": 2 * BATCH_BYTES}
    assert totals["data.h2d_pinned_bytes"] == {"count": 2, "total": 0}
    assert totals["data.to_device"]["count"] == 2


def test_benchmark_reader_of_the_copy_counters(monkeypatch):
    harness, reader = _reader("train.h2d_pinned_pct")
    train = harness.Run(stats={"kind": "train"})
    tracing.reset()
    assert reader.read(train) is None  # an untraced run: no counter

    step = {"train.step": {"count": 4, "host_ms": 800.0, "self_ms": 8.0, "device_ms": None}}
    table = dict(step, **{"data.h2d_pinned_bytes": {"count": 4, "total": 300},
                          "data.h2d_pageable_bytes": {"count": 4, "total": 100}})
    monkeypatch.setattr(tracing, "totals", lambda: table)
    assert reader.read(train) == pytest.approx(75.0)
    assert reader.read(harness.Run(stats={"kind": "decode"})) is None
    # a program with the spans and without the counters
    monkeypatch.setattr(tracing, "totals", lambda: step)
    assert reader.read(train) is None
    # counters of a run with no micro-step, or that copied nothing
    monkeypatch.setattr(tracing, "totals", lambda: {k: v for k, v in table.items()
                                                    if k != "train.step"})
    assert reader.read(train) is None
    monkeypatch.setattr(tracing, "totals", lambda: dict(step, **{
        name: {"count": 4, "total": 0} for name in COUNTERS}))
    assert reader.read(train) is None


def _transducer_step(criterion, model, batch):
    loss, _ = criterion(model, batch, train=True)
    loss.backward()


def test_transducer_spans_record_once_a_forward_only_under_a_profiler():
    from liteasr_tpu_torch import tasks
    from liteasr_tpu_torch.config import compose

    cfg = compose(["task=synthetic", "model=my_transducer", "criterion=my_rnnt",
                   "task.vocab_size=12", "task.feat_dim=16", "model.enc_arch=conformer",
                   "model.enc_dim=32", "model.enc_ff_dim=64", "model.enc_layers=1",
                   "model.dec_dim=16", "model.dec_units=20", "model.joint_dim=24"])
    task = tasks.setup_task(cfg.task)
    torch.manual_seed(0)
    model = task.build_model(cfg.model, device=torch.device("cpu"),
                             generator=torch.Generator().manual_seed(0))
    criterion = task.build_criterion(cfg.criterion)
    B, T, U = 3, 40, 5
    batch = {"xs": torch.randn(B, T, 16), "xlens": torch.tensor([40, 33, 21]),
             "ys": torch.randint(1, 12, (B, U)), "ylens": torch.tensor([5, 2, 1]),
             "valid": torch.ones(B)}
    tracing.reset()
    _transducer_step(criterion, model, batch)
    assert tracing.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            _transducer_step(criterion, model, batch)
    totals = tracing.totals()
    assert set(totals) == set(RNNT) | {"rnnt.lattice_cells", "rnnt.dp_plain_rows",
                                       "layer_norm.plain_rows"}
    for name in RNNT:
        assert totals[name]["count"] == 2, name
        assert totals[name]["host_ms"] > 0 and totals[name]["device_ms"] is None, name
    t_sub = ((T - 1) // 2 - 1) // 2  # the conv2d front end's frames
    assert totals["rnnt.lattice_cells"] == {"count": 2, "total": 2 * B * t_sub * (U + 1) * 12}
    assert totals["rnnt.dp_plain_rows"] == {"count": 2, "total": 2 * B}
    # the conformer block's five LayerNorms and the encoder's last, a forward
    assert totals["layer_norm.plain_rows"] == {"count": 12, "total": 12 * B * t_sub}
    spans = tracing.spans()
    assert [s.name for s in spans] == list(RNNT) * 2  # in the forward's order
    assert not set(RNNT) & _event_names(prof)


def test_dp_row_counters_name_the_plain_loop_on_the_cpu():
    from liteasr_tpu_torch.ops.rnnt import rnnt_loss

    rng = np.random.default_rng(4)
    B, T, U, V = 5, 9, 4, 7
    logits = torch.from_numpy(rng.normal(size=(B, T, U + 1, V)).astype(np.float32))
    args = (torch.from_numpy(rng.integers(1, V, (B, U))), torch.tensor([9, 7, 5, 2, 1]),
            torch.tensor([4, 3, 1, 0, 2]))
    tracing.reset()
    rnnt_loss(logits, *args).sum()
    assert tracing.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        rnnt_loss(logits.requires_grad_(), *args).sum().backward()
    totals = tracing.totals()
    assert totals["rnnt.dp_plain_rows"] == {"count": 1, "total": B}
    assert "rnnt.dp_kernel_rows" not in totals
    assert totals["rnnt.dp"]["count"] == 1


def test_benchmark_reader_of_the_lattice_counter(monkeypatch):
    harness, reader = _reader("train.rnnt_lattice_mcells")
    train = harness.Run(stats={"kind": "train"})
    tracing.reset()
    assert reader.read(train) is None  # an untraced run: no counter

    step = {"train.step": {"count": 4, "host_ms": 800.0, "self_ms": 8.0, "device_ms": None}}
    table = dict(step, **{"rnnt.lattice_cells": {"count": 4, "total": 6_000_000_000}})
    monkeypatch.setattr(tracing, "totals", lambda: table)
    assert reader.read(train) == pytest.approx(1500.0)
    assert reader.read(harness.Run(stats={"kind": "decode"})) is None
    # a program with the spans and without the counter (a U2 cell, the parent)
    monkeypatch.setattr(tracing, "totals", lambda: step)
    assert reader.read(train) is None


def test_profile_dir_trace_carries_the_spans(corpus, tmp_path):
    from liteasr_tpu_torch import train

    trainer = train.main(_overrides(corpus, tmp_path / "run", "optimization.max_epoch=1",
                                    "postprocess.workflow=[]",
                                    f"common.profile_dir={tmp_path / 'prof'}"),
                         device=torch.device("cpu"))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    rows = [e for e in trace["traceEvents"] if e.get("pid") == tracing.PID and e["ph"] == "X"]
    steps = [e for e in rows if e["name"] == "train.step"]
    assert len(steps) == trainer.step == 3
    assert {e["name"] for e in rows} == set(NAMES)
    assert {e["args"]["step"] for e in rows if e["name"].startswith("train.")} == {0, 1, 2}
    assert {e["tid"] for e in rows if e["name"] == "data.collate"}.isdisjoint(
        {e["tid"] for e in steps})
    # on the trace's time base: the model's products all lie inside the
    # micro-steps' spans (to the microsecond the trace rounds to)
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("name") == "aten::addmm"
           and e.get("pid") != tracing.PID]
    assert ops
    for op in ops:
        assert any(s["ts"] - 1 <= op["ts"] <= op["ts"] + op["dur"] <= s["ts"] + s["dur"] + 1
                   for s in steps), op


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stream times come from CUDA events")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_spans_leave_the_device_timeline_alone_on_the_card(corpus, tmp_path, cuda):
    trainer = _trainer(corpus, tmp_path, cuda)
    _micro_steps(trainer, 2)  # builds the kernels, warms the allocator
    torch.cuda.synchronize(cuda)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _micro_steps(trainer, 3)
        torch.cuda.synchronize(cuda)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    from torch.autograd import DeviceType

    on_device = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA}
    assert on_device, "the profiler recorded no device activity"
    assert not set(NAMES) & on_device
    totals = tracing.totals()
    assert totals["train.step"]["count"] == 3
    for name in PHASES:
        assert totals[name]["device_ms"] > 0, name
    assert sum(totals[p]["device_ms"] for p in PHASES) <= wall_ms
    assert totals["train.step"]["device_ms"] <= wall_ms
