"""``k1_launches.*``: K1 launches a unit of work (map evaluations a
step), from the port's own counter ``evolve_cuda.LAUNCHES`` read before
and after the window."""


def read(ctx):
    if not ctx.work:
        return None
    return (ctx.after["k1_launches"] - ctx.before["k1_launches"]) / ctx.work
