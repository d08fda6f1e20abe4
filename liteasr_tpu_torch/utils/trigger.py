"""Periodic event scheduling for the host-side training loop (a copy of
liteasr_tpu/utils/trigger.py, which is framework-free).

The trainer advances two counters — optimizer iterations and data epochs —
and polls a small scheduler after each advance; the scheduler decides which
registered callbacks (report_loss / valid / save_model / inference) are due.
Capability parity: liteasr/utils/trigger.py:6-66.

One deliberate behavioral change vs the reference: an event fires whenever
its counter has crossed the next interval boundary, not only when it lands
exactly on it. Exact-equality firing silently breaks after a mid-training
resume (the counter is restored to e.g. 1000 while the trigger still waits
for exactly 100, so nothing ever fires again); boundary-crossing plus
``align()`` keeps resumed runs validating and checkpointing.
"""

from typing import Callable, List

EPOCH = "epoch"
ITERATION = "iteration"


class PeriodicEvent:
    """A callback that is due every ``interval`` advances of one counter."""

    def __init__(self, callback: Callable[[], None], interval: int, unit: str):
        if unit not in (EPOCH, ITERATION):
            raise ValueError(f"trigger unit must be epoch/iteration, got {unit!r}")
        if int(interval) <= 0:
            raise ValueError(f"trigger interval must be positive, got {interval}")
        self.callback = callback
        self.interval = int(interval)
        self.unit = unit
        self._fired_boundary = 0  # highest interval boundary handled so far

    def align(self, count: int) -> None:
        """Mark every boundary at or below ``count`` as already handled.

        Called after a resume restores the trainer counters, so the event
        waits for the *next* boundary instead of firing for all the history
        the pre-restart run already covered.
        """
        self._fired_boundary = (count // self.interval) * self.interval

    def poll(self, count: int, unit: str) -> None:
        if unit == self.unit and count - self._fired_boundary >= self.interval:
            self.align(count)
            self.callback()


class EventManager:
    """Registry of periodic events, polled by the trainer."""

    def __init__(self):
        self._events: List[PeriodicEvent] = []

    def register(self, callback: Callable[[], None], interval: int,
                 unit: str) -> PeriodicEvent:
        event = PeriodicEvent(callback, interval, unit)
        self._events.append(event)
        return event

    def align(self, iteration: int, epoch: int) -> None:
        for event in self._events:
            event.align(iteration if event.unit == ITERATION else epoch)

    def poll(self, count: int, unit: str) -> None:
        for event in self._events:
            event.poll(count, unit)

    # trainer-facing entry points
    def trigger_epoch_events(self, trainer) -> None:
        self.poll(trainer.epoch, EPOCH)

    def trigger_iteration_events(self, trainer) -> None:
        self.poll(trainer.iter, ITERATION)
