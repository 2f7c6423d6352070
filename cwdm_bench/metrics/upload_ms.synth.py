"""Host ms a request of the program's ``cwdm.upload`` spans (every
``as_tensor`` onto the card in ``prepare_condition`` and the synthesis
``run``: the three modalities, the mask); the median over the traced
block's device-only requests (``cwdm_bench/spans.py``)."""

from cwdm_bench import spans


def read(rec):
    return spans.per_item(rec, ("cwdm.condition", "cwdm.synthesize"), ("cwdm.upload",),
                          "host_ms")
