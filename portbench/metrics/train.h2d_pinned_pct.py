"""Page-locked bytes as a share of the bytes that ``trainer.to_device``
copied to the device in the traced micro-steps: the program's counters
``data.h2d_pinned_bytes`` and ``data.h2d_pageable_bytes``. A program
without the counters, or whose traced micro-steps copied nothing, reads
nothing."""

import program_spans


def read(run):
    table = program_spans.totals(run)
    if table is None:
        return None
    pinned = table.get("data.h2d_pinned_bytes", {}).get("total")
    pageable = table.get("data.h2d_pageable_bytes", {}).get("total")
    if pinned is None or pageable is None or not pinned + pageable:
        return None
    return 100.0 * pinned / (pinned + pageable)
