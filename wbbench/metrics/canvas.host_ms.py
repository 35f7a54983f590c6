"""canvas.host_ms: host milliseconds a call in the canvas step's spans
(``wb.octaves``, ``wb.planes``, ``wb.channels``)."""

from wbbench.layers import CANVAS, per_call_ms


def read(ctx):
    return per_call_ms(ctx, CANVAS, "host_s")
