"""``step_s``: host clock over the whole window divided by the
continuation steps its sweeps completed, ``--stability`` included."""


def read(ctx):
    if ctx.work_unit != "step" or not ctx.work:
        return None
    return ctx.window_s / ctx.work
