"""The fused GN→SiLU→conv kernels' share of their roofline in the traced
block, in %: Σ over the forwards' fused convs of max(operations / peak,
bytes / 3.35 TB/s), each conv counted once from its shapes (2·27·Ci·Co·V
operations; input, weights and output once), over the device time of the
fused conv kernels' records. Peak: bf16 989 TFLOP/s, float32 495 (TF32).
Left out where the run fused no conv or the trace misses records."""

from cwdm_bench import devtrace
from cwdm_bench.counts import unet


def read(rec):
    tr = rec["trace"]
    if not tr or tr["records_missing"] or not tr["busy_s"] or not rec["model"].get("fuse_conv"):
        return None
    bf16 = rec["model"]["dtype"] == "bfloat16"
    pk = unet.peaks()
    bound = unet.fused_bound_s(rec["model"], rec["latent"],
                               pk["ops_per_s"]["bfloat16" if bf16 else "tf32"],
                               pk["bytes_per_s"], 2 if bf16 else 4, rec["batch"])
    spent = sum(s for name, (s, _) in tr["kernels"].items()
                if any(k in name for k in devtrace.FUSED_CONV_KERNELS))
    if not spent:
        return None
    return 100.0 * bound * rec["trace_items"] * rec["forwards_per_item"] / spent
