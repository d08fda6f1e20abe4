"""``torch.cuda.max_memory_allocated`` over the window (reset at its
start), in GiB: what decides the batch a card holds."""


def read(run):
    s = run.stats
    if s.get("kind") != "train" or not s.get("peak_bytes"):
        return None
    return s["peak_bytes"] / 2 ** 30
