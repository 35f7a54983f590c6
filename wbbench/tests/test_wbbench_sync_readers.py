"""The readers of ``nms.rounds``, ``host.syncs`` and ``host.sync_ms`` on
reduced traces made by hand: a count or time a call where the program
records ``wb.nms.round`` and ``wb.sync`` spans, nothing where it records
none (a program without these spans, or a call without NMS)."""

import pytest

from wbbench.harness import load_metric


def _ctx(calls=4, **spans):
    layers = {name.replace("__", "."): {"host_s": host_s, "device_s": 0.0,
                                        "count": count}
              for name, (count, host_s) in spans.items()}
    return {"calls": calls, "trace": {"layers": layers}}


#: four calls of 30 rounds and 31 reads each, 2 ms a call waiting
TRACED = _ctx(wb__nms=(4, 0.1), wb__nms__round=(120, 0.05),
              wb__sync=(124, 0.008))


@pytest.mark.parametrize("name,want", [("nms.rounds", 30.0),
                                       ("host.syncs", 31.0),
                                       ("host.sync_ms", 2.0)])
def test_reads_a_call(name, want):
    assert load_metric(name)(TRACED) == pytest.approx(want)


def test_no_round_reads_zero_rounds():
    """Every frame empty: the loop's one test, no round."""
    ctx = _ctx(wb__nms=(4, 0.01), wb__sync=(4, 0.001))
    assert load_metric("nms.rounds")(ctx) == 0
    assert load_metric("host.syncs")(ctx) == 1
    assert load_metric("host.sync_ms")(ctx) == pytest.approx(0.25)


def test_waits_without_nms_read_no_rounds():
    """Host waits outside NMS (a copy to the host) and no ``wb.nms``."""
    ctx = _ctx(wb__sync=(20, 0.004))
    assert load_metric("nms.rounds")(ctx) is None
    assert load_metric("host.syncs")(ctx) == 5
    assert load_metric("host.sync_ms")(ctx) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["nms.rounds", "host.syncs",
                                  "host.sync_ms"])
@pytest.mark.parametrize("ctx", [
    _ctx(wb__nms=(4, 0.1)),              # a program without the spans
    _ctx(wb__cascade=(4, 0.01)),         # no NMS, no host wait
    _ctx(),
    _ctx(calls=0, wb__nms=(0, 0.0), wb__sync=(0, 0.0))])
def test_nothing_to_read_reads_none(name, ctx):
    assert load_metric(name)(ctx) is None
