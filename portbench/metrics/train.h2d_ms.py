"""Host milliseconds a traced micro-step spends copying its batch to the
device, any wait for the stream included: the program's
``data.to_device`` span (``trainer.to_device``) over the count of
``train.step``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "data.to_device", "host_ms")
