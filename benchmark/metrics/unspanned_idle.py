"""``unspanned_idle.*``: the share in % of the traced window in which the
device idled while the host was inside no program span: the benchmark
loop's own work between units, or program code that no span covers
(:mod:`benchmark.spans`).  With ``cli_idle``, ``solver_idle`` and
``map_idle`` it adds up to ``device_idle`` up to the window's ends."""

from benchmark.spans import idle_share


def read(ctx):
    return idle_share(ctx, None)
