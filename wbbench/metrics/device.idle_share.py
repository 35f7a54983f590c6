"""device.idle_share: percent of the traced window in which no device
operation ran, averaged over the cell's chips."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["n_device_events"] or tr["idle_share"] is None:
        return None
    return 100.0 * tr["idle_share"]
