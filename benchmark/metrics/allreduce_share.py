"""``allreduce_share.*``: the share in % of the traced window in which
rank 0's card ran NCCL's all-reduce kernels (the harness process's
device trace).  An NCCL kernel spins until every rank has arrived, so
the share holds the collective's latency and the wait for the slowest
rank.  None on an untraced run or where the window ran no such kernel."""

from benchmark.yardstick import union_seconds


def is_allreduce(name: str) -> bool:
    low = name.lower()
    return low.startswith("nccl") and "allreduce" in low


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    spans = [(s, s + d) for n, s, d in t.kernels if is_allreduce(n)]
    if not spans:
        return None
    return 100.0 * union_seconds(spans) / ctx.window_s
