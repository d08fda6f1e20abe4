"""Stream milliseconds a traced micro-step spends in the transducer's joint
(``lin_enc`` and ``lin_dec``, their sum and tanh, the projection to the
(B, T', U+1, V) lattice): the time between the timing events that the
program's ``rnnt.joint`` span (``models.transducer``) records on the
current stream, over the count of ``train.step``. The joint's forward
only; its backward runs inside ``train.backward``."""

import program_spans


def read(run):
    return program_spans.per_step(run, "rnnt.joint", "device_ms")
