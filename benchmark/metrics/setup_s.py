"""``setup_s``: host clock from the process's start to the window's start
(imports, the kernels' build or load, the draws, the warm-up)."""


def read(ctx):
    return ctx.setup_s
