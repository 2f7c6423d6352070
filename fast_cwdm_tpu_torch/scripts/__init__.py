"""Benchmarks and calibration scripts of the port, run as ``python -m fast_cwdm_tpu_torch.scripts.<name>``."""
