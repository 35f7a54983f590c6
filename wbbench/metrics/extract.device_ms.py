"""extract.device_ms: device milliseconds a call of the operations
launched in ``wb.extract`` (kernel S2 and the boxes)."""

from wbbench.layers import EXTRACT, per_call_ms


def read(ctx):
    return per_call_ms(ctx, EXTRACT, "device_s")
