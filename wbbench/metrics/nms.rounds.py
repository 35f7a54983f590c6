"""nms.rounds: ``wb.nms.round`` spans a call, the rounds of the greedy
NMS loop (``ops/nms.py::nms``: one a box that the batch's fullest frame
keeps); 0 where the loop found nothing to keep.  None where the trace
has no ``wb.nms``, or no ``wb.sync``: a program that does not mark its
NMS rounds and host waits."""


def read(ctx):
    layers = ctx["trace"]["layers"]
    if "wb.nms" not in layers or "wb.sync" not in layers \
            or not ctx["calls"]:
        return None
    return layers.get("wb.nms.round", {"count": 0})["count"] / ctx["calls"]
