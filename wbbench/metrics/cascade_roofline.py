"""cascade_roofline: percent of the cascade's device time that the least
time of its work takes (``wbbench/roofline.py::cascade_work`` over the
reference's walk of the same frames) at the H100's peaks."""

from wbbench import roofline
from wbbench.layers import CASCADE, per_call_ms


def read(ctx):
    ms = per_call_ms(ctx, CASCADE, "device_s")
    if not ms or not ctx["runs"]:
        return None
    least = roofline.mean_least_s(roofline.cascade_work, ctx["runs"],
                                  ctx["config"])
    return 100.0 * least * 1e3 / ms
