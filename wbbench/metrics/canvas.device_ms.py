"""canvas.device_ms: device milliseconds a call of the operations
launched in the canvas step's spans (octave chain, B1, B2 or B5)."""

from wbbench.layers import CANVAS, per_call_ms


def read(ctx):
    return per_call_ms(ctx, CANVAS, "device_s")
