"""The rel-pos attention kernels' share of their roofline in the traced
micro-steps (K1' and K2 of ``ops.flash_attention``): the least time of
their calls (``flops.fwd_bound`` and ``flops.bwd_bound`` from the call
shapes) over the device time of the kernels named ``rel_attn_fwd*``,
``rel_attn_bwd*`` and ``bwd_prep_kernel``. A trace with none of those
kernels reads nothing."""


def read(run):
    t = run.trace
    if t is None or run.stats.get("kind") != "train":
        return None
    names = t.get("attn_kernels", ())
    busy = sum(s for n, s in t["kernel_s"].items() if any(k in n for k in names))
    if busy <= 0 or not t.get("attn_bound_s"):
        return None
    return 100.0 * t["attn_bound_s"] / busy
