"""``allreduces.*``: the all-reduces a unit of work (a continuation step)
from the program's own counter ``parallel.sharding.ALL_REDUCES`` of the
harness process, rank 0, read before and after the window: each is one
collective of every rank.  None on a window with no work, or where the
loop reads no such counter."""


def read(ctx):
    before = ctx.before.get("all_reduces")
    after = ctx.after.get("all_reduces")
    if not ctx.work or before is None or after is None:
        return None
    return (after - before) / ctx.work
