"""Median ms of the benchmark's span around ``prepare_condition`` (the three
modalities' upload and their DWTs), synchronised, over the traced block's
requests."""

import statistics


def read(rec):
    spans = rec["spans"].get("condition_ms")
    return statistics.median(spans) if spans else None
