"""What the per-layer metric readers share: the program's span names of
each layer, and a layer's time per call from the reduced trace."""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["CANVAS", "CASCADE", "EXTRACT", "NMS", "per_call_ms"]

#: the program's spans (``wb.*``) of each layer
CANVAS = ("wb.octaves", "wb.planes", "wb.channels")
CASCADE = ("wb.cascade",)
EXTRACT = ("wb.extract",)
NMS = ("wb.nms",)


def per_call_ms(ctx: dict, spans: Sequence[str],
                field: str) -> Optional[float]:
    """Milliseconds a call of ``field`` (``"host_s"`` or ``"device_s"``)
    summed over ``spans``; None where the trace has none of them, or,
    for device time, no device operation at all."""
    if field == "device_s" and not ctx["trace"]["n_device_events"]:
        return None
    layers = ctx["trace"]["layers"]
    got = [layers[s][field] for s in spans if s in layers]
    if not got or not ctx["calls"]:
        return None
    return sum(got) / ctx["calls"] * 1e3
