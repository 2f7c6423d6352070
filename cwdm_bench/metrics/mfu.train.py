"""Three forwards' operations a step (forward, and the backward's two
products; the recomputation under remat not counted) × the window's steps,
over the window's seconds and 989 TFLOP/s (bf16), in %."""

from cwdm_bench.counts import unet


def read(rec):
    peak = unet.peaks()["ops_per_s"][
        "bfloat16" if rec["model"]["dtype"] == "bfloat16" else "tf32"]
    ops = 3.0 * unet.forward_operations(rec["model"], rec["latent"], rec["batch"])
    return 100.0 * ops * rec["items"] / rec["window_s"] / peak
