"""``k2t_roofline``: K2T's (the tangent replay kernel's) share of its
roofline over the traced window
(:func:`benchmark.yardstick.roofline_share`)."""

from benchmark.yardstick import roofline_share


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_share(
        ctx.trace, "atorch::replay_tangent",
        lambda n: "replay_tangent_kernel" in n,
        ctx.config["n_real"], ctx.config["model"]["n_spikes"],
        ctx.traffic.get("events_per_row",
                        ctx.config["events_per_row"])["value"],
        "float64")
