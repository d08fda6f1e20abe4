"""Host milliseconds a traced micro-step spends launching the RNN-T loss's
forward DP, a Python loop over the lattice's T' frames: the program's
``rnnt.dp`` span (``ops.rnnt.lattice_nll``) over the count of
``train.step``. The DP's backward runs inside ``train.backward``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "rnnt.dp", "host_ms")
