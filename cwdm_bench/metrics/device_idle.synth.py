"""Share of the traced block's wall time in which no operation ran on the
device, in %."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["records_missing"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
