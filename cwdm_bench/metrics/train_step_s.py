"""The window's seconds / the optimizer steps completed in it (host clock,
synchronised at the window's end)."""


def read(rec):
    return rec["window_s"] / rec["items"]
