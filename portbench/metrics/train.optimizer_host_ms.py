"""Host milliseconds a traced micro-step spends in the optimizer's update
and clearing the gradients (accumulating and applying micro-steps
averaged): the program's ``train.optimizer`` span
(``Trainer.train_step``) over the count of ``train.step``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "train.optimizer", "host_ms")
