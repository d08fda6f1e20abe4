"""The whole train step's share of the card's bf16 peak: the operations
the window's micro-steps need (``flops.u2_train_flops`` of every real
utterance: three times the forward's products) over the window's seconds
and 989 TFLOP/s."""

import flops


def read(run):
    s = run.stats
    if s.get("kind") != "train" or not s.get("window_s"):
        return None
    return 100.0 * s["flops"] / s["window_s"] / flops.PEAK_FLOPS["bfloat16"]
