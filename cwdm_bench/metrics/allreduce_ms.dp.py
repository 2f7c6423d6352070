"""Device ms a step of the data axis's all-reduce: the program's
``cwdm.train.allreduce`` span (the gradients' and metrics' flattening,
all-reduce and scaling) by its CUDA events, on every rank, in each step of
the traced block's device-only half, where every rank runs under the
profiler alike (``training_dp.allreduce_ms_by_rank``). A rank that reaches
the all-reduce before the others waits in it for the last, so the largest
rank's ms a step holds the wait for the slowest rank; the reading is the
median over the steps of that largest. Nothing where a rank recorded no such
span (a program without it, or the CPU)."""

import statistics


def read(rec):
    by_rank = rec.get("allreduce_ms_by_rank")
    if not by_rank:
        return None
    return statistics.median(max(step) for step in zip(*by_rank))
