"""``k1_events_per_row.*``: K1's (the evolve kernel's) events over its
rows, summed over every launch of the traced window, from the port's own
counters (``utils.profiling.K1_COUNTERS``, which count only while a
profiler records; the window's is the run's only profiler).  It is
context for the rooflines, which take a configuration's fixed events a
row, not a target: ``"better": "lower"`` only because a metric needs a
direction.  None on an untraced run or where the program has no such
counter."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from armadillocudalinearinterpolation_torch.utils.profiling import (
            K1_COUNTERS)
    except ImportError:
        return None
    c = K1_COUNTERS.snapshot()
    return c["events"] / c["rows"] if c["rows"] else None
