"""The model's operations over the window (every conv and dense layer of a
forward, counted once from the configuration's shapes, × the forwards run)
over the window's seconds and the card's peak in the configuration's compute
dtype, in %: bf16 989 TFLOP/s; float32 495 TFLOP/s, the card's highest
rate for fp32 inputs (TF32), so that no route can read over 100 %."""

from cwdm_bench.counts import unet


def read(rec):
    peak = unet.peaks()["ops_per_s"][
        "bfloat16" if rec["model"]["dtype"] == "bfloat16" else "tf32"]
    ops = unet.forward_operations(rec["model"], rec["latent"], rec["batch"])
    return 100.0 * ops * rec["items"] * rec["forwards_per_item"] / rec["window_s"] / peak
