"""The reference against the program's CPU path, bitwise, and its
control against the reference."""

import os

import numpy as np
import pytest
import torch

from wbbench.harness import compare
from wbbench.reference.detector import OUTPUTS, ReferenceDetector
from wbbench.reference.model_file import read_model
from wbbench.reference.pyramid import pack, pyramid_plan
from wbbench.traffic import make_pool

MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")
FLAGSHIP = os.path.join(MODELS, "flagship_synth_64.pb")
FPGA = os.path.join(MODELS, "fpga_4k_synth_64.pb")

CASES = [
    (FLAGSHIP, (240, 320), 1024, "scenes"),
    (FLAGSHIP, (240, 320), 16, "scenes"),   # more survivors than slots
    (FLAGSHIP, (120, 160), 64, "noise"),
    (FPGA, (240, 320), 128, "scenes"),
    (FPGA, (96, 128), 32, "noise"),
]


def _program(path, hw, k, frames):
    import waldboost_tpu_torch as wt
    from waldboost_tpu_torch.parallel.detect import \
        make_batched_detector_boxes
    model = wt.load(path, device="cpu")
    fn, _ = make_batched_detector_boxes(model, hw, k=k, nms_iou=0.5,
                                        device="cpu")
    return {key: o.numpy() for key, o in zip(OUTPUTS, fn(frames))}


@pytest.mark.parametrize("path,hw,k,kind", CASES)
def test_reference_is_the_program_bitwise(path, hw, k, kind):
    frames = make_pool({"frames": kind}, hw, 3, 2**33 + 11, "cpu")
    want, stats = ReferenceDetector(path, hw, k, 0.5)(frames)
    got = _program(path, hw, k, frames)
    assert compare(got, want) == 0
    assert stats["n_weak"] == int(got["n_weak"].sum())


def test_scenes_exercise_boxes_and_nms():
    frames = make_pool({"frames": "scenes"}, (240, 320), 4, 2**33 + 7,
                       "cpu")
    out, stats = ReferenceDetector(FLAGSHIP, (240, 320), 1024, 0.5)(frames)
    valid = np.isfinite(out["scores"])
    assert stats["survivors"] > 0
    assert out["keep"].sum() < valid.sum()  # NMS dropped some


@pytest.mark.parametrize("path,control", [(FLAGSHIP, "bf16"),
                                          (FPGA, "int4")])
def test_control_fails_the_comparison(path, control):
    hw = (240, 320)
    frames = make_pool({"frames": "scenes"}, hw, 4, 2**33 + 7, "cpu")
    want, _ = ReferenceDetector(path, hw, 128, 0.5)(frames)
    low, _ = ReferenceDetector(path, hw, 128, 0.5, control=control)(frames)
    assert compare(low, want) > 0


def test_bf16_is_no_control_for_integer_channels():
    """The FPGA family's channels are integers up to 255, which bfloat16
    holds exactly: rounding the canvas there changes nothing, so that
    configuration's control is 4 bits."""
    hw = (240, 320)
    frames = make_pool({"frames": "scenes"}, hw, 2, 2**33 + 7, "cpu")
    want, _ = ReferenceDetector(FPGA, hw, 128, 0.5)(frames)
    low, _ = ReferenceDetector(FPGA, hw, 128, 0.5, control="bf16")(frames)
    assert compare(low, want) == 0


@pytest.mark.parametrize("path", [FLAGSHIP, FPGA])
def test_model_file_reader(path):
    from waldboost_tpu_torch import model_io
    from waldboost_tpu_torch.model import stage_from_fields
    mine = read_model(path)
    msg = model_io.read_model_file(path)
    assert list(mine.shape) == list(msg["shape"])
    assert mine.func == msg["channel_opts"]["func"]
    np.testing.assert_array_equal(mine.theta, msg["theta"])
    for a, tree in zip(mine.stages, msg["classifier"]):
        b = stage_from_fields(tree)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("hw,n_per_oct,halo", [((480, 640), 8, 1),
                                               ((2160, 3840), 4, 0),
                                               ((96, 128), 8, 1)])
def test_packing_is_the_serving_layout(hw, n_per_oct, halo):
    from waldboost_tpu_torch.packing import _packed_plan_cached
    mine = pack(pyramid_plan(*hw, 2, n_per_oct), (12, 12), halo, 2)
    theirs = _packed_plan_cached(*hw, 2, n_per_oct, (12, 12), halo=halo)
    assert (mine.canvas_h, mine.canvas_w) == (theirs.canvas_h,
                                              theirs.canvas_w)
    assert [(p.y, p.x, p.plan_index) for p in mine.levels] == \
        [(p.y, p.x, p.plan_index) for p in theirs.levels]
    np.testing.assert_array_equal(mine.valid_mask((12, 12)),
                                  theirs.valid_mask((12, 12)))


def test_scene_frames_are_the_scene_generator():
    from waldboost_tpu_torch.utils import scene_generator
    from wbbench.traffic import scene
    gen = scene_generator(seed=5, hw=(120, 160))
    rng = np.random.RandomState(5)
    for _ in range(4):
        assert np.array_equal(next(gen)["image"], scene(rng, (120, 160)))


def test_pool_is_a_function_of_the_seed():
    for kind in ("noise", "scenes"):
        t = {"frames": kind}
        a = make_pool(t, (48, 64), 8, 2**40 + 3, "cpu", 4)
        b = make_pool(t, (48, 64), 8, 2**40 + 3, "cpu", 4)
        c = make_pool(t, (48, 64), 8, 2**40 + 4, "cpu", 4)
        assert a.dtype == torch.uint8 and torch.equal(a, b)
        assert not torch.equal(a, c)
