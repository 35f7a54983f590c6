"""nms.device_ms: device milliseconds a call of the operations launched
in ``wb.nms``: kernel S3, or, in a program that runs the greedy loop on
the card, the loop's small ops, which it launches in ``wb.nms`` and in
its rounds' ``wb.nms.round`` spans."""

from wbbench.layers import NMS, per_call_ms


def read(ctx):
    return per_call_ms(ctx, NMS + ("wb.nms.round",), "device_s")
