"""The 85th percentile of the wall seconds of every request in the window,
from its cases' upload to its volume on the host (host clock). At about 70
volumes a window it keeps ten samples beyond it."""

import statistics


def read(rec):
    return statistics.quantiles(rec["item_s"], n=20, method="inclusive")[16]
