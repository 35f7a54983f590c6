"""step_mfu: percent of a call's wall time that the least time of its
whole work takes on the cell's chips (``wbbench/roofline.py::
step_work``): frames in, model, outputs out, and the arithmetic the
algorithm needs for these frames."""

from wbbench import roofline


def read(ctx):
    if not ctx["calls"] or ctx["trace"]["window_s"] <= 0:
        return None
    per_call_s = ctx["trace"]["window_s"] / ctx["calls"]
    least = roofline.mean_least_s(roofline.step_work, ctx["runs"],
                                  ctx["config"], ctx["chips"])
    return 100.0 * least / per_call_s
