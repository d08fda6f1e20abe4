"""Millions of lattice cells, B x T' x (U+1) x V, a traced micro-step's
transducer loss holds: the program's counter ``rnnt.lattice_cells``
(``ops.rnnt.lattice_log_probs``) over the count of ``train.step``. A
program without the counter reads nothing."""

import program_spans


def read(run):
    table = program_spans.totals(run)
    if table is None or not table.get("rnnt.lattice_cells", {}).get("count"):
        return None
    return table["rnnt.lattice_cells"]["total"] / table["train.step"]["count"] / 1e6
