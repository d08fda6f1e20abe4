"""What the readers of the program's spans share: the totals that the
port's span recorder (``liteasr_tpu_torch.utils.tracing``) holds after a
traced run, per traced micro-step. The recorder is on only while a
profiler records, so its totals cover the traced micro-steps alone. A
program without the recorder, a run that is not a train run, and a run
that recorded no ``train.step`` read nothing."""


def totals(run):
    """The recorder's totals by span name, or None."""
    if run.stats.get("kind") != "train":
        return None
    try:
        from liteasr_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    table = tracing.totals()
    if not table.get("train.step", {}).get("count"):
        return None
    return table


def per_step(run, name: str, key: str):
    """``key`` (``host_ms`` or ``device_ms``) of the spans ``name`` over the
    traced micro-steps (the count of ``train.step``), or None."""
    table = totals(run)
    if table is None or table.get(name, {}).get(key) is None:
        return None
    return table[name][key] / table["train.step"]["count"]


def per_span(run, name: str, key: str):
    """``key`` of the spans ``name`` over their own count, or None."""
    table = totals(run)
    if table is None or not table.get(name, {}).get("count") or table[name].get(key) is None:
        return None
    return table[name][key] / table[name]["count"]
