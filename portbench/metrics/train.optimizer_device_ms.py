"""Stream milliseconds a traced micro-step spends in the optimizer's update
and clearing the gradients (accumulating and applying micro-steps
averaged): the time between the timing events that the program's
``train.optimizer`` span records on the current stream (from the phase's
first queued work to its last, idle included) over the count of
``train.step``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "train.optimizer", "device_ms")
