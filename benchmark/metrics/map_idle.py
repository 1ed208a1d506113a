"""``map_idle.*``: the share in % of the traced window in which the
device idled while the innermost program span on the host was the map's
(``map.*``: an evaluation, its lift, restriction, mean and tangents; with
``parallel.*``, the all-reduce of a sharded map's mean;
:mod:`benchmark.spans`)."""

from benchmark.spans import idle_share


def read(ctx):
    return idle_share(ctx, "map", "parallel")
