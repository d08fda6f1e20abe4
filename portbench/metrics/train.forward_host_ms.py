"""Host milliseconds a traced micro-step spends in the front end,
SpecAugment and the criterion's forward: the program's ``train.forward``
span (``Trainer.train_step``) over the count of ``train.step``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "train.forward", "host_ms")
