"""``device_idle.*``: the share in % of the traced window in which no
operation ran on the device (``torch.profiler``'s device events, their
union against the window's host clock)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
