"""Host milliseconds a micro-step waits for its batch: taking it from the
port's loader (``data.loader``, the collator of ``data.dataset``) and
``trainer.to_device``, on the benchmark's clock, over the window."""


def read(run):
    s = run.stats
    if s.get("kind") != "train" or not s.get("steps"):
        return None
    return 1e3 * s["input_wait_s"] / s["steps"]
