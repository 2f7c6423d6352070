"""Device ms per reverse step of the chain (a UNet forward and the step's
posterior and x0 clip, replayed from the captured graph): the device time
of the traced block's operations, less what lies outside the chain
(``devtrace.OUTSIDE_CHAIN``: the copies between host and card, the
condition's DWTs, the volume's IDWT, the benchmark's noise draws), over
the forwards run. What stays besides the chain: the condition's
concatenation and the volume's clamp, mask and crop, a few elementwise
passes over one volume a request. Left out where the trace holds fewer
kernel records than the program's launch counters say ran."""

from cwdm_bench import devtrace


def read(rec):
    tr = rec["trace"]
    if not tr or tr["records_missing"] or not tr["busy_s"]:
        return None
    outside = sum(s for s, _ in devtrace.outside_chain(tr["kernels"]).values())
    forwards = rec["trace_items"] * rec["forwards_per_item"]
    return 1e3 * (sum(s for s, _ in tr["kernels"].values()) - outside) / forwards
