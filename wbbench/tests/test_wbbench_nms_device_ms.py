"""The reader of ``nms.device_ms`` on reduced traces made by hand: device
milliseconds a call in ``wb.nms`` and its rounds' ``wb.nms.round`` spans,
nothing where the trace has no device events, no ``wb.nms`` or no call."""

import pytest

from wbbench.harness import load_metric


def _ctx(n_device_events=100, calls=4, **device_s):
    layers = {name.replace("__", "."): {"host_s": 0.01, "device_s": t,
                                        "count": calls}
              for name, t in device_s.items()}
    return {"calls": calls, "trace": {"layers": layers,
                                      "n_device_events": n_device_events}}


@pytest.mark.parametrize("ctx,want", [
    # kernel S3: one launch a call in wb.nms, 25 us each
    (_ctx(wb__nms=0.0001, wb__cascade=0.002), 0.025),
    # the plain loop on the card: set-up in wb.nms, its ops in the rounds
    (_ctx(wb__nms=0.0004, wb__nms__round=0.0116, wb__sync=0.001), 3.0),
    # no kept box: the loop's one test and no round
    (_ctx(wb__nms=0.0002), 0.05)])
def test_reads_a_call(ctx, want):
    assert load_metric("nms.device_ms")(ctx) == pytest.approx(want)


@pytest.mark.parametrize("ctx", [
    _ctx(n_device_events=0, wb__nms=0.0),   # no device operation
    _ctx(wb__cascade=0.002),                # no NMS
    _ctx(calls=0, wb__nms=0.0)])
def test_without_nms_device_time_reads_none(ctx):
    assert load_metric("nms.device_ms")(ctx) is None
