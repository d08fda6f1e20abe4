"""Utterances whose RNN-T loss DP ran in the CUDA kernels, as a share of
those whose DP ran at all in the traced micro-steps: the program's
counters ``rnnt.dp_kernel_rows`` and ``rnnt.dp_plain_rows``
(``ops.rnnt.lattice_nll``; the plain one is the Python loop over T'). A
program without the counters, or whose traced micro-steps ran no DP, reads
nothing."""

import program_spans


def read(run):
    table = program_spans.totals(run)
    if table is None:
        return None
    kernel = table.get("rnnt.dp_kernel_rows", {}).get("total")
    plain = table.get("rnnt.dp_plain_rows", {}).get("total")
    if kernel is None and plain is None:
        return None
    kernel, plain = kernel or 0, plain or 0
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
