"""Stream milliseconds a traced micro-step spends in the lattice's fp32
log-softmax over the vocabulary and the blank and label gathers: the time
between the timing events that the program's ``rnnt.lattice`` span
(``ops.rnnt.lattice_log_probs``) records on the current stream, over the
count of ``train.step``. The forward only."""

import program_spans


def read(run):
    return program_spans.per_step(run, "rnnt.lattice", "device_ms")
