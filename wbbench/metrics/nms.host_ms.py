"""nms.host_ms: host milliseconds a call in ``wb.nms`` (the greedy loop,
one round a kept box of the fullest frame)."""

from wbbench.layers import NMS, per_call_ms


def read(ctx):
    return per_call_ms(ctx, NMS, "host_s")
