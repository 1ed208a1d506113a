"""``solver_idle.*``: the share in % of the traced window in which the
device idled while the innermost program span on the host was a
solver's (``solvers.*``: the Newton loops, Jacobians, linear solves,
stages; :mod:`benchmark.spans`)."""

from benchmark.spans import idle_share


def read(ctx):
    return idle_share(ctx, "solvers")
