"""``solve_s``: host clock over the whole window divided by the solves it
completed, in a cell whose unit of work is a solve."""


def read(ctx):
    if ctx.work_unit != "solve" or not ctx.work:
        return None
    return ctx.window_s / ctx.work
