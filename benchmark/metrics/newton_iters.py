"""``newton_iters.*``: the mean over the window's solves of the Newton
iterations each took, every stage counted (``NewtonResult.iterations``)."""


def read(ctx):
    its = [i for r in ctx.records for i in r.get("iterations", [])]
    return sum(its) / len(its) if its else None
