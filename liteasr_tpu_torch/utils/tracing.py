"""Spans of the train step and the data path, on the profiler's clock.

A span is recorded exactly while a ``torch.profiler`` records on the
calling thread: a traced window of a benchmark, or a run under
``common.profile_dir``. Otherwise :func:`span` costs one check and hands
back a shared no-op, with no clock read and no allocation.

While on, a span stamps its start and end with ``time.time_ns()``, the
clock of the profiler's own events, so that it lines up with the ops and
kernels of the trace. Each thread keeps a stack of its open spans, so a
span knows its parent and its self time (its time less its children's).
On a CUDA device a span also records a timing event on the current
stream at its start and at its end: their elapsed time is the stream's
time for the phase, from its first queued work to its last, idle
included. The events are resolved as they complete, so a whole-run
profile keeps only the events still in flight. A span emits nothing into
the profiler: a ``record_function`` annotation would be mirrored on the
device's timeline and read there as device work.

The spans, each where the work happens:

=================== ==================================================
``train.step``      ``Trainer.train_step``: one micro-step, parent of
                    the three below
``train.forward``   the front end, SpecAugment and the criterion's
                    forward
``train.backward``  ``loss.backward()``
``train.optimizer`` the optimizer's update and clearing the gradients
``data.wait``       ``EpochDataLoader.epoch_iter`` blocked on a batch
                    its workers have not finished
``data.collate``    one batch's collation on a loader worker, stamped
                    there and recorded by the consumer that takes it
``data.to_device``  ``trainer.to_device``: the host-to-device copy,
                    any wait for the stream included
``rnnt.predictor``  the transducer's prediction network
                    (``models.transducer``), inside ``train.forward``
``rnnt.joint``      the transducer's joint, to the (B, T', U+1, V)
                    lattice
``rnnt.lattice``    ``ops.rnnt.lattice_log_probs``: the lattice's
                    log-softmax and the blank and label gathers
``rnnt.dp``         ``ops.rnnt.lattice_nll``: the forward DP (on a
                    CUDA device its one kernel launch, on the CPU
                    the plain loop over T')
=================== ==================================================

A span outside a micro-step (the data spans) belongs to the micro-step
that follows it. The records are a bounded ring of the last
:data:`RING` spans, and beside it each name's totals; :func:`totals`
reads the totals, :func:`spans` the ring, and :func:`export_chrome_trace`
appends the ring to a profiler's Chrome trace as rows of its own.

A counter (:func:`add`) records, under the same switch, a sum and the
number of its additions:

=========================== ==========================================
``data.h2d_pinned_bytes``   ``trainer.to_device``: bytes copied to the
                            device from page-locked host memory
``data.h2d_pageable_bytes`` the same, from pageable host memory
``rnnt.lattice_cells``      ``ops.rnnt.lattice_log_probs``: the cells
                            B x T' x (U+1) x V of each lattice
``rnnt.dp_kernel_rows``     ``ops.rnnt.lattice_nll``: the utterances
                            whose DP ran in the CUDA kernels
``rnnt.dp_plain_rows``      the same, in the plain loop over T'
=========================== ==========================================
"""

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

RING = 1 << 16  # spans kept for export: ~8,000 micro-steps of 8 spans
PID = "liteasr_tpu_torch spans"  # the Chrome trace's process of the span rows


def recording() -> bool:
    """Whether a profiler records on the calling thread."""
    return torch._C._autograd._profiler_enabled()


@dataclass
class Span:
    """One recorded span. ``parent``: the name of the span open around it
    on its thread (None at the top); ``step``: the micro-step it belongs
    to (None until one follows); ``device_ms``: the stream's time for it
    (None off a CUDA device, or until its events have completed)."""

    name: str
    parent: Optional[str]
    step: Optional[int]
    thread: str
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None


class _Off:
    """The span of a thread that no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Open:
    """A span being recorded, on the stack of its thread."""

    __slots__ = ("recorder", "name", "device", "step", "parent", "start_ns",
                 "child_ns", "events")

    def __init__(self, recorder, name, device, step):
        self.recorder, self.name, self.device, self.step = recorder, name, device, step

    def __enter__(self):
        stack = self.recorder._stack()
        self.parent = stack[-1] if stack else None
        if self.step is None and self.parent is not None:
            self.step = self.parent.step
        elif self.step is not None and self.parent is None:
            self.recorder._assign_step(self.step)
        stack.append(self)
        self.child_ns, self.events = 0, None
        self.start_ns = time.time_ns()
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        return None

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
        end_ns = time.time_ns()
        self.recorder._stack().pop()
        total = end_ns - self.start_ns
        if self.parent is not None:
            self.parent.child_ns += total
        rec = Span(self.name, self.parent.name if self.parent is not None else None,
                   self.step, threading.current_thread().name, self.start_ns, end_ns)
        self.recorder._add(rec, total - self.child_ns,
                           None if self.events is None else self.events[:2])
        return False


class Recorder:
    """The ring of spans and each name's totals, shared by the threads of
    a process (the module's functions use one)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self):
        """Forget every span and total (open spans still close into the
        new records)."""
        with self._lock:
            self._spans: deque = deque(maxlen=RING)
            self._totals: Dict[str, List] = {}  # name -> [count, host, self ns, device ms, timed]
            self._pending: deque = deque()  # (Span, start event, end event) in flight
            self._unstepped: deque = deque(maxlen=RING)
            self._counters: Dict[str, List[int]] = {}  # name -> [count, total]

    def span(self, name: str, device=None, step: Optional[int] = None):
        """A context manager that records ``name`` while a profiler records
        on this thread. ``device``: a CUDA device adds the stream's time;
        ``step``: the micro-step, given by the span that opens one (the
        others take their parent's, or the next one's)."""
        if not recording():
            return OFF
        return _Open(self, name, device, step)

    def record(self, name: str, start_ns: int, end_ns: int,
               step: Optional[int] = None, thread: Optional[str] = None):
        """Record a span timed elsewhere (on another thread, whose
        ``time.time_ns()`` stamps these are), if a profiler records on the
        calling thread."""
        if not recording():
            return
        self._add(Span(name, None, step, thread or threading.current_thread().name,
                       int(start_ns), int(end_ns)), int(end_ns) - int(start_ns), None)

    def add(self, name: str, amount: int):
        """Add ``amount`` to the counter ``name``, if a profiler records on
        the calling thread."""
        if not recording():
            return
        with self._lock:
            counter = self._counters.setdefault(name, [0, 0])
            counter[0] += 1
            counter[1] += int(amount)

    def spans(self) -> List[Span]:
        """The ring's spans, oldest first, device times resolved."""
        with self._lock:
            self._resolve(wait=True)
            return list(self._spans)

    def totals(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Each span name's ``count``, ``host_ms`` (the spans' sum),
        ``self_ms`` (less their children) and ``device_ms`` (the stream's,
        None where no span of the name ran on a CUDA device), and each
        counter's ``count`` (its additions) and ``total``, over every
        record since :meth:`reset`. Waits for the pending device events:
        synchronize the device first, or this blocks until it has caught
        up."""
        with self._lock:
            self._resolve(wait=True)
            table = {name: {"count": c, "host_ms": h * 1e-6, "self_ms": s * 1e-6,
                            "device_ms": d if timed else None}
                     for name, (c, h, s, d, timed) in self._totals.items()}
            table.update({name: {"count": c, "total": t}
                          for name, (c, t) in self._counters.items()})
            return table

    def export_chrome_trace(self, path: str):
        """Append the ring's spans to the ``torch.profiler`` Chrome trace at
        ``path`` as rows of their own (a row per thread under the process
        :data:`PID`), on the trace's time base (``baseTimeNanoseconds``)."""
        with open(path) as f:
            trace = json.load(f)
        base_ns = int(trace.get("baseTimeNanoseconds", 0))
        rows = trace["traceEvents"]
        rows.append({"ph": "M", "name": "process_name", "pid": PID, "tid": 0,
                     "args": {"name": PID}})
        for s in self.spans():
            rows.append({"ph": "X", "cat": "span", "name": s.name, "pid": PID,
                         "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                         "dur": (s.end_ns - s.start_ns) / 1e3,
                         "args": {"step": s.step, "parent": s.parent,
                                  "device_ms": s.device_ms}})
        with open(path, "w") as f:
            json.dump(trace, f)

    # ------------------------------------------------------------ inside

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _assign_step(self, step: int):
        with self._lock:
            for rec in self._unstepped:
                rec.step = step
            self._unstepped.clear()

    def _add(self, rec: Span, self_ns: int, events):
        with self._lock:
            self._spans.append(rec)
            tot = self._totals.setdefault(rec.name, [0, 0, 0, 0.0, 0])
            tot[0] += 1
            tot[1] += rec.end_ns - rec.start_ns
            tot[2] += self_ns
            if rec.step is None:
                self._unstepped.append(rec)
            if events is not None:
                self._pending.append((rec, *events))
            self._resolve(wait=False)

    def _resolve(self, wait: bool):
        """Fold the completed device events into their spans and totals,
        in the order they were recorded; ``wait`` for those in flight."""
        while self._pending:
            rec, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            rec.device_ms = start.elapsed_time(end)
            tot = self._totals[rec.name]
            tot[3] += rec.device_ms
            tot[4] += 1


_RECORDER = Recorder()
span = _RECORDER.span
record = _RECORDER.record
add = _RECORDER.add
spans = _RECORDER.spans
totals = _RECORDER.totals
reset = _RECORDER.reset
export_chrome_trace = _RECORDER.export_chrome_trace
