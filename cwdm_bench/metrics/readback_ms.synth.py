"""Device ms a request of the program's ``cwdm.readback`` span (the
volume's copy to the host, after the chain's last kernel), by its CUDA
events; the median over the traced block's device-only requests
(``cwdm_bench/spans.py``)."""

from cwdm_bench import spans


def read(rec):
    return spans.per_item(rec, ("cwdm.synthesize",), ("cwdm.readback",), "device_ms")
