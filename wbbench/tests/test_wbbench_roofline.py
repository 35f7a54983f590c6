"""The counts the rooflines divide by are lower bounds: checked against
a walk done by hand, window by window, on a small frame."""

import os

import numpy as np
import pytest

from wbbench import roofline
from wbbench.reference.detector import ReferenceDetector
from wbbench.traffic import make_pool

MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")


def test_least_time_takes_the_larger_bound_over_the_chips():
    assert roofline.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.least_s(3.35e12, 2 * 67e12, chips=4) == \
        pytest.approx(0.5)


@pytest.mark.parametrize("name,bytes_a_value", [
    ("flagship_synth_64.pb", 4), ("fpga_4k_synth_64.pb", 1)])
def test_cascade_counts_are_the_walk_done_by_hand(name, bytes_a_value):
    hw = (96, 128)
    ref = ReferenceDetector(os.path.join(MODELS, name), hw, 64, 0.5)
    frames = make_pool({"frames": "scenes"}, hw, 2, 2**33 + 3, "cpu")
    cv = ref.canvas(frames).numpy()
    *_, stats = ref.walk(ref.canvas(frames))
    read, evals, entries = set(), 0, 0
    mdl = ref.model
    for b in range(cv.shape[0]):
        for r, c in zip(*np.nonzero(ref.valid)):
            hs = np.float32(0)
            for s, theta in zip(mdl.stages, ref.theta):
                entries += 1
                node = 0
                while s["left"][node] >= 0:
                    fr, fc, ch = s["feature"][node]
                    read.add((b, ch, r + fr, c + fc))
                    evals += 1
                    v = cv[b, ch, r + fr, c + fc]
                    node = s["left"][node] if v <= s["threshold"][node] \
                        else s["right"][node]
                hs = np.float32(hs + s["prediction"][node])
                if not hs >= theta:
                    break
    assert stats["canvas_values_read"] == len(read)
    assert stats["node_evals"] == evals
    n_bytes, ops = roofline.cascade_work(
        dict(stats, n_weak=entries, survivors=0, frames=2),
        {"canvas_value_bytes": bytes_a_value})
    assert ops == evals + 2 * entries
    # at most the whole canvas once, and the values some node read
    assert len(read) * bytes_a_value <= n_bytes
    assert len(read) <= cv.size


def test_step_counts_count_each_input_and_output_once():
    stats = dict(frames=2, k_slots=4, model_values=10, level_pixels=100,
                 channels=4, canvas_values=80, canvas_values_read=50,
                 node_evals=30, n_weak=20, survivors=1)
    n_bytes, ops = roofline.step_work(stats, {"frame_hw": [8, 10],
                                              "canvas_value_bytes": 4})
    assert n_bytes == 2 * 80 + 40 + 2 * (4 * 21 + 8)
    assert ops == 2 * (100 * 5 + 80) + 30 + 40
