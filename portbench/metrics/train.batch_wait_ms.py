"""Host milliseconds a traced micro-step blocks on a batch that the
loader's workers have not finished: the program's ``data.wait`` span
(``EpochDataLoader.epoch_iter``) over the count of ``train.step``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "data.wait", "host_ms")
