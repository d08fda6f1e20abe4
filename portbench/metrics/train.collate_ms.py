"""Host milliseconds of one batch's collation on a loader worker: the
program's ``data.collate`` spans (stamped in ``EpochDataLoader._load``)
over their count, the batches taken in the traced micro-steps."""

import program_spans


def read(run):
    return program_spans.per_span(run, "data.collate", "host_ms")
