"""Padded frames as a share of the frames of the window's batches, from
the shapes the port's collator made."""


def read(run):
    s = run.stats
    if s.get("kind") != "train" or not s.get("padded_frames"):
        return None
    return 100.0 * (1.0 - s["real_frames"] / s["padded_frames"])
