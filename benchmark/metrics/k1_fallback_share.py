"""``k1_fallback_share.*``: of K1's events in its windowed launches
(``evolve_window > 0``) over the traced window, the share in % that fell
back from the certified window to every lane, from the port's own
counters (``utils.profiling.K1_COUNTERS``, which count only while a
profiler records).  None on an untraced run, where no launch ran the
window, or where the program has no such counter."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from armadillocudalinearinterpolation_torch.utils.profiling import (
            K1_COUNTERS)
    except ImportError:
        return None
    c = K1_COUNTERS.snapshot()
    if not c["windowed_events"]:
        return None
    return 100.0 * c["fallback_events"] / c["windowed_events"]
