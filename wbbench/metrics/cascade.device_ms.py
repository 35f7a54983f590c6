"""cascade.device_ms: device milliseconds a call of the operations
launched in ``wb.cascade`` (kernel B3)."""

from wbbench.layers import CASCADE, per_call_ms


def read(ctx):
    return per_call_ms(ctx, CASCADE, "device_s")
