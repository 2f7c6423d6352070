"""Host ms a step of the program's ``cwdm.train.backward`` spans
(``loss.backward()``); the median over the traced block's device-only steps
(``cwdm_bench/spans.py``)."""

from cwdm_bench import spans


def read(rec):
    return spans.per_item(rec, ("cwdm.train.step",), ("cwdm.train.backward",), "host_ms")
