"""The reader of ``train.rnnt_dp_kernel_pct`` on hand-built span tables:
nothing from a program without the DP's row counters (a parent commit, a
U2 cell) or from a run without traced micro-steps; 100 where every row ran
in the kernels, as on the card; the kernels' share where both ran."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402
from liteasr_tpu_torch.utils import tracing  # noqa: E402

STEP = {"train.step": {"count": 4, "host_ms": 800.0, "self_ms": 8.0, "device_ms": 600.0}}


@pytest.fixture
def reader():
    return harness.load_module("metrics", "train.rnnt_dp_kernel_pct")


def test_reads_nothing_without_the_counters(reader, monkeypatch):
    train = harness.Run(stats={"kind": "train"})
    tracing.reset()
    assert reader.read(train) is None  # an untraced run
    monkeypatch.setattr(tracing, "totals", lambda: dict(STEP))
    assert reader.read(train) is None  # spans, but no DP counters
    monkeypatch.setattr(tracing, "totals", lambda: {
        "rnnt.dp_kernel_rows": {"count": 4, "total": 360}})
    assert reader.read(train) is None  # counters, but no micro-step
    assert reader.read(harness.Run(stats={"kind": "decode"})) is None


@pytest.mark.parametrize("kernel,plain,want", [(360, None, 100.0), (None, 360, 0.0),
                                               (270, 90, 75.0), (0, 0, None)])
def test_reads_the_kernels_share(reader, monkeypatch, kernel, plain, want):
    table = dict(STEP)
    for name, total in (("rnnt.dp_kernel_rows", kernel), ("rnnt.dp_plain_rows", plain)):
        if total is not None:
            table[name] = {"count": 4, "total": total}
    monkeypatch.setattr(tracing, "totals", lambda: table)
    got = reader.read(harness.Run(stats={"kind": "train"}))
    assert got == (None if want is None else pytest.approx(want))
