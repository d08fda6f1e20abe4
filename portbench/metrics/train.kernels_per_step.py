"""Device kernels a micro-step launches, counted in the traced steps."""


def read(run):
    t = run.trace
    if t is None or run.stats.get("kind") != "train" or not t["steps"]:
        return None
    return t["kernels"] / t["steps"]
