"""The benchmark's plumbing: find a cell's files by name, check the card,
read the device trace, and print the result line.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the model's sizes and the port's overrides;
* ``traffic/<mix>.json``: the parameters of :mod:`generator`'s generator,
  and the ``driver`` that runs the mix;
* ``drivers/<driver>.py``: a ``run(cell)`` that drives one entry of the
  port and returns a :class:`Run`;
* ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's value
  from a traced run, or None where it finds nothing to read;
* ``limits/<workload>.json``: the limits of the cell's correctness check.

A new cell, mix or metric is new files and a new entry in
``BENCHMARK.json``; no file here needs an edit.
"""

import bisect
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "liteasr_tpu")
NAME_CHARS = 120  # of a kernel's or host op's name in the breakdown


class SetupError(RuntimeError):
    """The cell cannot run here: a missing file, card or chip count."""


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: Any = None          # a torch.device; the driver's tests pass a CPU one
    control: str = ""           # "" or a fault / control the run plants (tests, calibration)
    t_start: float = 0.0        # the process's start on the host clock


@dataclass
class Run:
    """What a driver hands back: the counts, the end-to-end metrics it
    took by the host clock, what the per-layer readers read, and the
    numbers of the correctness comparison, each beside its limit."""

    attempted: int = 0
    failed: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    checks: List[Dict[str, float]] = field(default_factory=list)  # name, value, limit
    memory_peak_bytes: int = 0
    stats: Dict[str, Any] = field(default_factory=dict)      # host-side counts for readers
    trace: Optional[Dict[str, Any]] = None                   # :func:`reduce_trace`'s output

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"] for c in self.checks)


def load_json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise SetupError(f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path} "
                         "is missing")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and limit files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SetupError(f"workload {name!r} names an unknown config {w['config']!r}")
    here = root / HERE.name
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]),
                config=load_json(root / configs[w["config"]]["file"]),
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"))


def load_module(kind: str, name: str, root: Path = ROOT):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (metric names hold dots)."""
    path = root / HERE.name / kind / f"{name}.py"
    if not path.is_file():
        raise SetupError(f"{kind}/{name}.py is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def per_layer_metrics(cell: Cell, root: Path = ROOT) -> List[Dict[str, Any]]:
    """The per-layer metrics that ``cell`` reports: those that list it,
    and those that list no cells but move an end-to-end metric it reports."""
    bench = benchmark(root)
    mine = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]}
    return [m for m in bench["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def end_to_end_metrics(cell: Cell, root: Path = ROOT) -> List[Dict[str, Any]]:
    return [m for m in benchmark(root)["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]]


# ------------------------------------------------------------------ device

def require_cards(count: int):
    """The cards a cell asks for, or :class:`SetupError`: a run never falls
    back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SetupError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < count:
        raise SetupError(f"the cell asks for {count} cards, "
                         f"{torch.cuda.device_count()} are here")


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it (None where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_record(count: int, memory_peak_bytes: int, trace=None) -> Dict[str, Any]:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(memory_peak_bytes), "power_limit": power_limit()}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``liteasr_tpu_torch`` is not ``liteasr_tpu``)."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def cache_environment(root: Path = ROOT):
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX. The port's own kernels
    build into ``build/liteasr_tpu_torch`` under the checkout by
    themselves."""
    build = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# ------------------------------------------------------------------- trace

def _union(spans):
    """Total length of the union of (start, end) intervals, and the gaps
    between them in order as (start, end)."""
    busy, end, gaps = 0.0, None, []
    for s, e in sorted(spans):
        if end is not None and s > end:
            gaps.append((end, s))
        busy += max(0.0, e - max(s, end if end is not None else s))
        end = e if end is None else max(end, e)
    return busy, gaps


def reduce_trace(events, window_s: float, steps: int) -> Dict[str, Any]:
    """Reduce a profiler's raw events to what the readers need.

    ``events``: (name, on_device, start_s, end_s) of every event. Device
    busy time is the union of the device intervals; the idle gaps between
    them are named by the innermost host event that covers the gap's
    start (``portbench.*`` phases are the benchmark's own annotations).
    ``steps``: the micro-steps or batches the window traced."""
    # the benchmark's own annotations are mirrored on the device's timeline:
    # they are host phases, not device work
    dev = [(s, e, n) for n, on_dev, s, e in events
           if on_dev and not n.startswith("portbench.")]
    host = [(s, e, n) for n, on_dev, s, e in events if not on_dev]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy, gaps = _union((s, e) for s, e, _ in dev)
    kernels = [(n, e - s) for s, e, n in dev if not n.startswith(("Memcpy", "Memset"))]
    by_name: Dict[str, float] = {}
    for n, d in kernels:
        by_name[n] = by_name.get(n, 0.0) + d
    host.sort()
    starts = [s for s, _, _ in host]
    phases = sorted((s, e, n) for s, e, n in host if n.startswith("portbench."))
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        phase = next((n for s, e, n in reversed(phases) if s <= g0 <= e), "none")
        op = None
        i = bisect.bisect_right(starts, g0) - 1
        for s, e, n in host[max(0, i - 64):i + 1][::-1]:
            if e >= g0 and not n.startswith("portbench."):
                op = n  # the innermost host event under way when the device went idle
                break
        label = phase if op is None else f"{phase} / {op}"
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy, "window_s": window_s, "steps": steps,
        "kernels": len(kernels), "kernel_s": by_name,
        "device_ops": [[n[:NAME_CHARS], s] for n, s in top[:10]],
        "idle_gaps": [[n[:NAME_CHARS], s]
                      for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def profile_events(prof):
    """(name, on_device, start_s, end_s) of a finished ``torch.profiler``
    run, read from its raw kineto events."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                    s + e.duration_ns() * 1e-9))
    return out


# ------------------------------------------------------------------ result

def result_line(cell: Cell, run: Run, device: Dict[str, Any],
                root: Path = ROOT) -> Dict[str, Any]:
    """The run's last line: the cell's end-to-end metrics (``--trace 0``)
    or the per-layer metrics its readers find (``--trace 1``); the numbers
    compared for ``correct`` come last, each beside its limit."""
    metrics = {}
    if cell.trace:
        for m in per_layer_metrics(cell, root):
            value = load_module("metrics", m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in end_to_end_metrics(cell, root):
            if m["name"] in run.metrics:
                metrics[m["name"]] = {"value": float(run.metrics[m["name"]]),
                                      "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if cell.trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in run.checks}
    return line


def print_checks(run: Run):
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for c in run.checks:
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)
