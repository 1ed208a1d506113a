"""``cli_idle.*``: the share in % of the traced window in which the
device idled while the innermost program span on the host was the CLI's
(``cli.*``: set-up, smoke evaluation, predictor, stability, checkpoints;
:mod:`benchmark.spans`)."""

from benchmark.spans import idle_share


def read(ctx):
    return idle_share(ctx, "cli")
