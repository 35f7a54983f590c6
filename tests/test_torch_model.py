"""PyTorch port, the Model API on the CPU against the JAX ``Model``:
``detect`` (JAX's two-phase path, its dense path for short cascades, and
its overflow fallback), ``detect_topk``, ``predict``, ``predict_on_image``,
``scan_packed``, ``scan_packed_batch``, ``survivor_histogram`` and the
cost counters; the entry points' device default; and, marked slow, the
committed JAX golden outputs of the three committed models on VGA scene
frames."""

import os

import numpy as np
import pytest
import torch

import waldboost_tpu as wb

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import device as tdev
from waldboost_tpu_torch.ops import cascade as tc
from waldboost_tpu_torch.ops import cascade_static as tcs

from torch_port_util import make_model_pair, noise_frames, sorted_rows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["flagship_synth_64", "flagship_hard_64", "flagship_hard_256"]


def _rows(boxes):
    return sorted_rows(boxes.get(), boxes.get_field("scores"))


def _prefix_survivors(tm, image, cap):
    """Windows alive after the first ``cap`` stages (port, plain)."""
    _, grid, canvas = tm._scan_setup(image[None])
    _, alive, _ = tcs.cascade_response(canvas, grid.valid, tm._operands(),
                                       n_stages_cap=cap)
    return int(alive.sum())


@pytest.mark.parametrize("hw,n_stages,open_stages,path", [
    ((96, 128), 8, 0, "dense"),        # <= 12 stages: JAX's dense path
    ((96, 128), 20, 0, "two_phase"),   # JAX: 12-stage prefix + suffix
    ((160, 256), 16, 12, "overflow"),  # JAX: prefix overflows, dense
])
def test_detect_matches_jax(hw, n_stages, open_stages, path):
    jm, tm = make_model_pair(n_stages=n_stages, seed=6,
                             open_stages=open_stages)
    img = noise_frames(1, hw, seed=11)[0]
    if path != "dense":
        count1 = _prefix_survivors(tm, img, 12)
        assert (count1 > 4096) == (path == "overflow")
    got, want = tm.detect(img), jm.detect(img)
    assert len(got) > 0 and got.get_field("scores").dtype == np.float32
    np.testing.assert_array_equal(_rows(got), _rows(want))
    assert (tm.n_weak, tm.n_loc) == (jm.n_weak, jm.n_loc)
    assert tm.eval_cost == jm.eval_cost


@pytest.mark.parametrize("nms_iou", [None, 0.3])
def test_detect_topk_matches_jax(nms_iou):
    jm, tm = make_model_pair(n_stages=10, seed=7)
    img = noise_frames(1, (96, 128), seed=12)[0]
    for k in (16, 4096):
        got = tm.detect_topk(img, k=k, nms_iou=nms_iou)
        want = jm.detect_topk(img, k=k, nms_iou=nms_iou)
        assert len(got) > 0
        # the same rows in the same order: score descending, then canvas
        # index ascending
        np.testing.assert_array_equal(got.get(), want.get())
        np.testing.assert_array_equal(got.get_field("scores"),
                                      want.get_field("scores"))
    assert (tm.n_weak, tm.n_loc) == (jm.n_weak, jm.n_loc)


@pytest.mark.parametrize("depth", [None, 5])
def test_predict_matches_jax(depth):
    jm, tm = make_model_pair(n_stages=12, seed=8, depth=depth)
    rng = np.random.RandomState(3)
    X = rng.uniform(0, 300, (37,) + jm.shape).astype(np.float32)
    for a, b in zip(tm.predict(X), jm.predict(X)):
        np.testing.assert_array_equal(a, b)
    assert tm.predict(X)[1].any() and not tm.predict(X)[1].all()
    for a, b in zip(tm.predict(X[:0]), jm.predict(X[:0])):
        np.testing.assert_array_equal(a, b)


def test_predict_on_image_matches_jax():
    jm, tm = make_model_pair(n_stages=12, seed=9, depth=5)
    X = np.random.RandomState(4).uniform(0, 300, (40, 52, 4)) \
        .astype(np.float32)
    got, want = tm.predict_on_image(X), jm.predict_on_image(X)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (tm.n_weak, tm.n_loc) == (jm.n_weak, jm.n_loc)
    small = np.zeros((6, 6, 4), np.float32)
    assert all(len(a) == 0 for a in tm.predict_on_image(small))


def test_scan_packed_matches_jax():
    jm, tm = make_model_pair(n_stages=20, seed=10)
    img = noise_frames(1, (96, 128), seed=13)[0]
    canvas, packed, rs, cs, scores = tm.scan_packed(img)
    jcanvas, jpacked, jrs, jcs, jscores = jm.scan_packed(img)
    assert packed.canvas_h == jpacked.canvas_h
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(jcanvas))
    for a, b in zip((rs, cs, scores), (jrs, jcs, jscores)):
        np.testing.assert_array_equal(a, b)
    assert len(rs) > 0
    assert (tm.n_weak, tm.n_loc) == (jm.n_weak, jm.n_loc)


def test_scan_packed_batch_matches_jax():
    jm, tm = make_model_pair(n_stages=12, seed=11)
    images = noise_frames(4, (48, 64), seed=14)
    canvas, hs, packed, per_image = tm.scan_packed_batch(images, n_real=3)
    jcanvas, jhs, _, jper = jm.scan_packed_batch(images, n_real=3)
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(jcanvas))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(jhs))
    assert len(per_image) == len(jper) == 3
    for (rs, cs), (jrs, jcs) in zip(per_image, jper):
        np.testing.assert_array_equal(rs, jrs)
        np.testing.assert_array_equal(cs, jcs)
    assert tm.cost_stats()["n_weak"] == jm.cost_stats()["n_weak"]
    assert tm.cost_stats()["n_images"] == 3


def test_survivor_histogram_and_cost_stats_match_jax():
    jm, tm = make_model_pair(n_stages=12, seed=12)
    images = noise_frames(2, (48, 64), seed=15)
    X = np.random.RandomState(5).uniform(0, 300, (30, 40, 4)) \
        .astype(np.float32)
    for m in (jm, tm):
        m.reset()
        m.survivor_histogram(images[0])
        m.detect(images[1])
        m.survivor_histogram(images[1])
        m.predict_on_image(X)
        m.detect_topk(images[0], k=64)
        m.scan_packed(images[1])
    np.testing.assert_array_equal(tm.survivor_histogram(images[0]),
                                  jm.survivor_histogram(images[0]))
    got, want = tm.cost_stats(), jm.cost_stats()
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["stage_survivors"].shape == (12,)
    assert 0 < got["eval_cost"] < 12


def test_container_protocol_and_boxes():
    jm, tm = make_model_pair(n_stages=3, seed=13)
    assert len(tm) == 3 and bool(tm) and not bool(wt.Model(tm.shape,
                                                           tm.channel_opts))
    for (stage, theta), (weak, jtheta) in zip(tm, jm):
        np.testing.assert_array_equal(stage["left"], weak.left)
        assert theta == np.float32(jtheta)
    assert tm[1][1] == tm.theta[1]
    r, c = np.array([0, 3, 7]), np.array([1, 2, 9])
    np.testing.assert_array_equal(tm.get_boxes(r, c, 0.37).get(),
                                  jm.get_boxes(r, c, 0.37).get())
    assert len(tm.get_boxes([], [], 0.5)) == 0


def test_model_errors():
    _, tm = make_model_pair(n_stages=3, seed=14)
    with pytest.raises(ValueError):
        tm.detect(np.zeros((2, 48, 64), np.uint8))
    # float frames are served (exact float serving); other types are not
    assert len(tm.detect(np.zeros((48, 64), np.float32))) >= 0
    with pytest.raises(ValueError, match="uint8 or float32"):
        tm.detect(np.zeros((48, 64), np.int16))
    assert len(tm.detect(np.zeros((6, 6), np.uint8))) == 0
    assert len(tm.detect_topk(np.zeros((6, 6), np.uint8))) == 0
    assert tm.scan_packed(np.zeros((6, 6), np.uint8)) is None
    with pytest.raises(ValueError):
        tm.predict(np.zeros((4, 7, 8, 4), np.float32))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """With no device given every entry point runs on the card, and
    without a card it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jm, cpu_model = make_model_pair(n_stages=3, seed=15)
    path = str(tmp_path / "m.pb")
    cpu_model.save(path)
    model = wt.load(path)  # loads; runs on the card when used
    img = noise_frames(1, (48, 64), seed=16)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.resolve_device(None)
    for call in (lambda: model.detect(img),
                 lambda: model.detect_topk(img),
                 lambda: model.scan_packed(img),
                 lambda: model.predict(np.zeros((2,) + model.shape, "f")),
                 lambda: wt.detect(img, model),
                 lambda: wt.make_batched_detector_boxes(model, (48, 64)),
                 lambda: wt.make_batched_detector(model, (48, 64)),
                 lambda: wt.make_multi_detector_boxes([model], (48, 64)),
                 lambda: wt.detect_batch(model, img[None]),
                 lambda: wt.model_from_stages(
                     model.shape, model.channel_opts, model.stages,
                     model.theta).detect(img),
                 lambda: tc.cascade_from_stages(model.stages, model.theta)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # device="cpu" given anywhere runs the plain versions on the CPU
    assert len(wt.load(path, device="cpu").detect(img)) == \
        len(model.to("cpu").detect(img)) == len(jm.detect(img))
    fn, _ = wt.make_batched_detector_boxes(wt.load(path), (48, 64),
                                           device="cpu")
    assert fn.device == torch.device("cpu")


@pytest.mark.slow
def test_golden_model_api_vga():
    """The committed JAX outputs (scripts/make_torch_model_golden.py) of
    Model.detect, detect_topk(k=1024, nms_iou=0.5), scan_packed and the
    three-model wt.detect on VGA scene frames, bitwise."""
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "torch_port_model_golden.npz"))
    frames = g["frames"]
    split = lambda key: np.split(g[key + "_rows"],
                                 np.cumsum(g[key + "_counts"])[:-1])
    models = [wt.load(os.path.join(ROOT, "models", n + ".pb"), device="cpu")
              for n in MODELS]
    for name, model in zip(MODELS, models):
        for i, (det, topk, scan) in enumerate(zip(
                split(name + "_detect"), split(name + "_topk"),
                split(name + "_scan"))):
            model.reset()
            np.testing.assert_array_equal(_rows(model.detect(frames[i])),
                                          sorted_rows(det[:, :4], det[:, 4]))
            assert model.n_weak == g[name + "_n_weak"][i]
            assert model.n_loc == g[name + "_n_loc"][i]
            got = model.detect_topk(frames[i], k=int(g["topk_k"]),
                                    nms_iou=float(g["nms_iou"]))
            np.testing.assert_array_equal(_rows(got),
                                          sorted_rows(topk[:, :4], topk[:, 4]))
            model.reset()
            _, _, rs, cs, sc = model.scan_packed(frames[i])
            np.testing.assert_array_equal(
                np.stack([rs, cs, sc], 1).astype(np.float32), scan)
            assert model.n_weak == g[name + "_scan_n_weak"][i]
    for i, rows in enumerate(split("multi")):
        got = wt.detect(frames[i], *models,
                        response_scale=list(g["response_scale"]))
        got_rows = np.concatenate([got.get(), got.get_field("scores")[:, None],
                                   got.get_field("label")[:, None]], 1
                                  ).astype(np.float32)
        np.testing.assert_array_equal(
            got_rows[np.lexsort(got_rows.T[::-1])],
            rows[np.lexsort(rows.T[::-1])])
