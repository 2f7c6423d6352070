"""Device ms a reverse step of the program's ``cwdm.chain`` span, by its
CUDA events, over the steps it counts: the chain's device time, the
static buffers' feeds and any wait between replays included; the median
over the traced block's device-only requests (``cwdm_bench/spans.py``)."""

from cwdm_bench import spans


def _per_step(item):
    chains = [s for s in item if s["name"] == "cwdm.chain"]
    if not chains or any(s["device_ms"] is None for s in chains):
        return None
    return sum(s["device_ms"] for s in chains) / sum(s["counts"]["steps"] for s in chains)


def read(rec):
    return spans.median_item(rec, ("cwdm.synthesize",), _per_step)
