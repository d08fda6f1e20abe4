"""The device's idle share in the traced micro-steps: 100 less the union
of the device's intervals over the traced wall time."""


def read(run):
    t = run.trace
    if t is None or run.stats.get("kind") != "train" or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
