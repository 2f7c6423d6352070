"""The model's operations over the window (every conv and dense layer of a
forward, ``counts/unet.py``, and every attention block's dense layers and
products, ``counts/attention.py``, counted once from the configuration's
shapes, × the forwards run) over the window's seconds and the card's bf16
peak, 989 TFLOP/s, in %."""

from cwdm_bench.counts import attention, unet


def read(rec):
    peak = unet.peaks()["ops_per_s"]["bfloat16"]
    ops = attention.forward_operations(rec["model"], rec["latent"], rec["batch"])
    return 100.0 * ops * rec["items"] * rec["forwards_per_item"] / rec["window_s"] / peak
