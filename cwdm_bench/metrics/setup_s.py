"""Set-up seconds: from the process's start to the first timed request or
step (imports, the kernels' build or cached load, weights, cases, the
program's warm-up: graph capture or the checked training steps)."""


def read(rec):
    return rec["setup_s"]
