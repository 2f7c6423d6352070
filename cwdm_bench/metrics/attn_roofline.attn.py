"""The attention kernel's share of its roofline in the traced block, in %:
Σ over the forwards' attention blocks of max(4·T²·C / 989 TFLOP/s, bytes /
3.35 TB/s) (``counts/attention.py``: q, k, v and the output once each, in
bf16), over the device time of the flash kernel's records
(``attention.FLASH_KERNELS``, the split-KV pass's combine included). Left
out where the program counted no fused attention launch
(``ops.launch_counts()["attention"]``) or the trace holds fewer flash
records than it counted, a launch's combine not counted as a record of it:
each launch runs one forward kernel, whole or split."""

from cwdm_bench.counts import attention, unet


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["busy_s"]:
        return None
    launched = tr["launched"].get("attention", 0)
    flash = [(name, v) for name, v in tr["kernels"].items()
             if any(k in name for k in attention.FLASH_KERNELS)]
    spent = sum(v[0] for _, v in flash)
    records = sum(v[1] for name, v in flash if attention.COMBINE not in name)
    if not launched or records < launched or not spent:
        return None
    pk = unet.peaks()
    bound = attention.flash_bound_s(rec["model"], rec["latent"], pk["ops_per_s"]["bfloat16"],
                                    pk["bytes_per_s"], 2, rec["batch"])
    return 100.0 * bound * rec["trace_items"] * rec["forwards_per_item"] / spent
