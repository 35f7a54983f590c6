"""The trace reduction on a Chrome trace made by hand."""

import pytest

from wbbench.trace import reduce_trace, union_length


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    ev = [
        _x("bench.window", "user_annotation", 0, 1000),
        _x("wb.cascade", "user_annotation", 100, 200),
        _x("wb.nms", "user_annotation", 400, 500),
        _x("bench.call", "user_annotation", 50, 950),
        # launches (host), matched to device events by correlation
        _x("cudaLaunchKernel", "cuda_runtime", 110, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 450, 5, correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 960, 5, correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 980, 5, correlation=5),
        # device 0: two overlapping kernels, then one in NMS
        _x("walk", "kernel", 130, 100, correlation=1, device=0),
        _x("walk", "kernel", 200, 100, correlation=2, device=0),
        _x("iou", "kernel", 460, 40, correlation=3, device=0),
        _x("Memcpy DtoH", "gpu_memcpy", 970, 10, correlation=4, device=0),
        # device 1: one kernel, running past the window's end
        _x("walk", "kernel", 990, 100, correlation=5, device=1),
        # outside the window: not counted
        _x("walk", "kernel", 2000, 100, correlation=9, device=0),
    ]
    return {"traceEvents": ev}


def test_union_length():
    assert union_length([(0, 10), (5, 15), (20, 30)]) == 25
    assert union_length([]) == 0


def test_busy_and_idle_over_the_window_and_devices():
    r = reduce_trace(_trace(), "bench.window", [0])
    # device 0: [130, 300) + [460, 500) + [970, 980) = 170 + 40 + 10 us
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx(220e-6)
    assert r["idle_share"] == pytest.approx(1 - 0.22)
    two = reduce_trace(_trace(), "bench.window", [0, 1])
    # device 1 busy [990, 1000) inside the window: the mean of 220 and 10
    assert two["busy_s"] == pytest.approx(115e-6)


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    r = reduce_trace(_trace(), "bench.window", [0, 1])
    layers = r["layers"]
    assert layers["wb.cascade"]["device_s"] == pytest.approx(200e-6)
    assert layers["wb.nms"]["device_s"] == pytest.approx(40e-6)
    # the copy and device 1's kernel (clipped) were launched in bench.call
    assert layers["bench.call"]["device_s"] == pytest.approx(20e-6)
    assert layers["wb.nms"]["host_s"] == pytest.approx(500e-6)
    assert layers["wb.cascade"]["count"] == 1
    assert r["device_ops"][0] == ("walk", pytest.approx(210e-6))


def test_idle_gaps_go_to_the_span_the_host_was_in():
    r = reduce_trace(_trace(), "bench.window", [0])
    gaps = dict(r["idle_gaps"])
    # device 0 idle [0,130), [300,460) (midpoint 380, before wb.nms)
    # and [980,1000) in bench.call; [500,970) in wb.nms (midpoint 735)
    assert gaps["wb.nms"] == pytest.approx(470e-6)
    assert gaps["bench.call"] == pytest.approx((130 + 160 + 20) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(780e-6)
