"""``k2_roofline``: K2's (the fp64 replay kernel's) share of its roofline
over the traced window (:func:`benchmark.yardstick.roofline_share`)."""

from benchmark.yardstick import roofline_share


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_share(
        ctx.trace, "atorch::replay",
        lambda n: "replay_kernel" in n and "tangent" not in n,
        ctx.config["n_real"], ctx.config["model"]["n_spikes"],
        ctx.traffic.get("events_per_row",
                        ctx.config["events_per_row"])["value"],
        "float64")
