"""host.sync_ms: host milliseconds a call inside ``wb.sync`` spans: the
host waiting for the card's queued work, and the read or copy itself.
None where the trace has none: a program that does not mark them."""


def read(ctx):
    sync = ctx["trace"]["layers"].get("wb.sync")
    if sync is None or not ctx["calls"]:
        return None
    return sync["host_s"] / ctx["calls"] * 1e3
