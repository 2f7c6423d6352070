"""Volumes completed in the window × 3600 / the window's seconds (host
clock, from the first request's start to the last one's return)."""


def read(rec):
    return rec["items"] * rec["batch"] * 3600.0 / rec["window_s"]
