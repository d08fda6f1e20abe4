"""Host milliseconds a traced micro-step spends in ``loss.backward()``: the
program's ``train.backward`` span (``Trainer.train_step``) over the
count of ``train.step``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "train.backward", "host_ms")
