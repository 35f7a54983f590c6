"""host.syncs: ``wb.sync`` spans a call, the points where the program's
host waits for the card (a read of a device value, a blocking copy).
None where the trace has none: a program that does not mark them."""


def read(ctx):
    sync = ctx["trace"]["layers"].get("wb.sync")
    if sync is None or not ctx["calls"]:
        return None
    return sync["count"] / ctx["calls"]
