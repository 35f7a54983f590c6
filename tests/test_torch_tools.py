"""PyTorch port on the CPU: the host tools (``waldboost_tpu_torch/
profiling.py``, the visualisation and callbacks of ``utils.py``) and
single-scale serving (``make_batched_detector_boxes(n_scales=...)``), each
held against the JAX package's counterpart on the same inputs.

Tolerances: 0 throughout.  ``Meter``'s counters, the drawn images and the
callbacks' output are equal; ``n_scales`` serving gives JAX's survivor
counts, n_weak and boxes and scores bitwise (boxes compared as sorted
rows) for exact uint8 frames, float32 frames, fast mode, FPGA channels
and the image-space canvas (shrink 1, grad_mag), at n_scales 1 and 2.
"""

import contextlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import boxes as jbx
from waldboost_tpu import utils as jutils
from waldboost_tpu.parallel import detect as jdet
from waldboost_tpu.profiling import Meter as JaxMeter
from waldboost_tpu.training import DTree

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import profiling
from waldboost_tpu_torch import utils as tutils

from test_cascade import random_stage
from test_model import make_model
from test_torch_fast import float_frames, jax_fast
from torch_port_util import make_model_pair, noise_frames, sorted_rows

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_of(jm):
    return wt.model_from_stages(jm.shape, jm.channel_opts,
                                [w.to_stage_dict() for w in jm.classifier],
                                jm.theta, device="cpu")


# -- profiling ----------------------------------------------------------------

def test_meter_note_model_matches_jax():
    """Both packages' Meter over the same model pair and frames: the
    cascade counters Model.detect tracked, folded in by note_model, are
    equal, and the report names them."""
    jm, tm = make_model_pair(n_stages=6, seed=1)
    for img in noise_frames(3, (48, 64), seed=2):
        jm.detect(img)
        tm.detect(img)
    a, b = JaxMeter(), profiling.Meter()
    a.note_model(jm, name="det")
    b.note_model(tm, name="det")
    assert b.counters == a.counters
    assert {"det.eval_cost", "det.worst_eval_cost", "det.n_images"} \
        <= set(b.counters) and b.counters["det.n_images"] == 3
    rep = b.report()
    assert "det.eval_cost" in rep and "det.worst_eval_cost" in rep


def test_meter_phases():
    m = profiling.Meter()
    x = torch.ones(4)
    for _ in range(2):
        with m.phase("detect", items=8, pixels=8e6, block_on=[x, {"y": x}]):
            x = x + 1
    assert m.items["detect"] == 16 and m.pixels["detect"] == 16e6
    assert m.totals["detect"] > 0
    line = m.report().splitlines()[0]
    assert line.startswith("detect: ") and "items/s" in line \
        and "MP/s" in line


def test_trace_writes_chrome_trace(tmp_path):
    profiling.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        profiling.start_trace(str(tmp_path))
    with profiling.trace_annotation("wb.test_span"):
        torch.ones(64).sum()
    path = profiling.stop_trace()
    with pytest.raises(RuntimeError):
        profiling.stop_trace()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "wb.test_span" in names


# -- utils ----------------------------------------------------------------------

def _scored_boxes(bx_mod, seed=0, n=12):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, 2))
    wh = rng.uniform(4, 20, (n, 2))
    rects = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    return bx_mod.Boxes(rects, scores=rng.randn(n).astype(np.float32))


@pytest.mark.parametrize("vrange", [(None, None), (-1.0, 2.0)])
def test_draw_detections_matches_jax(vrange):
    img = noise_frames(1, (64, 80), seed=3)[0]
    gt = np.array([[5, 6, 30, 40], [40, 10, 70, 50]], np.float32)
    kw = dict(dt_thickness=2, gt_thickness=3, vmin=vrange[0],
              vmax=vrange[1])
    want = jutils.draw_detections(img, _scored_boxes(jbx), jbx.Boxes(gt),
                                  **kw)
    got = tutils.draw_detections(img, _scored_boxes(wt.bbx), wt.Boxes(gt),
                                 **kw)
    assert got.shape == (64, 80, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tutils.draw_detections(img, None),
                                  jutils.draw_detections(img, None))
    np.testing.assert_array_equal(
        tutils._score_palette(np.arange(5.0), None, None),
        jutils._score_palette(np.arange(5.0), None, None))


def test_montage_agg(monkeypatch):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    X = np.random.RandomState(0).rand(5, 12, 12, 1).astype(np.float32)
    fig = tutils.montage(X, nrows=2, ncols=3)
    ref = jutils.montage(X, nrows=2, ncols=3)
    try:
        axes = fig.get_axes()
        assert len(axes) == 6
        assert [len(ax.images) for ax in axes] == [1] * 5 + [0]
        assert tuple(fig.get_size_inches()) == tuple(ref.get_size_inches())
        np.testing.assert_array_equal(axes[2].images[0].get_array(),
                                      ref.get_axes()[2].images[0].get_array())
    finally:
        plt.close(fig)
        plt.close(ref)


def test_show_image_callback(monkeypatch):
    """The callback shows the model's detections drawn as JAX's does once
    the fpr is below max_fpr, and nothing before."""
    import cv2
    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda name, im: shown.append(im))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    jm, tm = make_model_pair(n_stages=4, seed=1)
    img = noise_frames(1, (48, 64), seed=5)[0]
    gt = np.array([[5, 6, 30, 40]], np.float32)

    class Learner:
        false_positive_rate = 0.5

    for mod, model, boxes in ((jutils, jm, jbx), (tutils, tm, wt.bbx)):
        cb = mod.ShowImageCallback(img, boxes.Boxes(gt), max_fpr=0.1)
        cb(model, Learner, 0)
        Learner.false_positive_rate = 0.05
        cb(model, Learner, 1)
        Learner.false_positive_rate = 0.5
    assert len(shown) == 2
    np.testing.assert_array_equal(shown[1], shown[0])


def test_class_prob_callback_matches_jax(capsys):
    class Learner:
        false_positive_rate = 0.0123456789
        true_positive_rate = 0.987654321

    jutils.class_prob_callback(None, Learner, 3)
    want = capsys.readouterr().out
    tutils.class_prob_callback(None, Learner, 3)
    assert capsys.readouterr().out == want == \
        "Stage 3:\n\tp0 = 0.01235; p1 = 0.98765\n"


# -- n_scales -------------------------------------------------------------------

def image_space_pair(opts, n_stages=4, thr_max=100.0, seed=0):
    """A JAX model over an image-space canvas (shrink 1 or grad_mag) with
    random depth-2 stumps, odd stages rejecting, and its port."""
    rng = np.random.RandomState(seed)
    shape = (8, 8, 4 if opts["channels"] == "grad_hist" else 1)
    jm = wb.Model(shape, opts)
    for t in range(n_stages):
        s = random_stage(rng, shape[:2], shape[2])
        s["threshold"] = rng.uniform(0, thr_max,
                                     len(s["threshold"])).astype("f")
        jm.append(DTree([tuple(f) for f in s["feature"]], s["threshold"],
                        s["left"], s["right"], s["prediction"]),
                  -0.6 if t % 2 else -np.inf)
    return jm, port_of(jm)


HW = (64, 96)
CASES = {
    "uint8": lambda: (*make_model_pair(n_stages=6), noise_frames(2, HW, 1)),
    "float": lambda: (*make_model_pair(n_stages=6), float_frames(2, HW, 2)),
    "fast": lambda: (*make_model_pair(n_stages=6), noise_frames(2, HW, 1)),
    "fpga": lambda: (*make_model_pair(n_stages=6, channels="grad_hist_4_u1"),
                     noise_frames(2, HW, 1)),
    "shrink1": lambda: (*image_space_pair(dict(shrink=1, n_per_oct=2,
                                               smooth=1,
                                               channels="grad_hist")),
                        noise_frames(2, HW, 3)),
    "grad_mag": lambda: (*image_space_pair(dict(shrink=2, n_per_oct=2,
                                                smooth=1,
                                                channels="grad_mag"),
                                           thr_max=2.0),
                         noise_frames(2, HW, 3)),
}


@pytest.mark.parametrize("n_scales", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_n_scales_matches_jax(case, n_scales):
    """JAX's make_batched_detector_boxes(n_scales=...) serves these
    options through its masked kernel path; the port's equals it: the
    plan's levels, counts, n_weak, and every valid box and score (no NMS;
    k above any count, so the counts are exact)."""
    jm, tm, imgs = CASES[case]()
    fast = case == "fast"
    ctx = jax_fast() if fast else contextlib.nullcontext()
    with ctx:
        jfn, jp = jdet.make_batched_detector_boxes(jm, HW, k=8192,
                                                   n_scales=n_scales)
        want = [np.asarray(a) for a in jfn(jnp.asarray(imgs))]
    tfn, tp = wt.make_batched_detector_boxes(tm, HW, k=8192,
                                             n_scales=n_scales,
                                             device="cpu", fast=fast)
    got = [a.numpy() for a in tfn(torch.from_numpy(imgs))]
    assert len(tp.levels) == len(jp.levels) == n_scales
    assert [(l.y, l.x, l.plan_index) for l in tp.levels] == \
        [(l.y, l.x, l.plan_index) for l in jp.levels]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    assert (got[3] > 0).all()
    for b in range(len(imgs)):
        np.testing.assert_array_equal(
            sorted_rows(got[0][b][got[2][b]], got[1][b][got[2][b]]),
            sorted_rows(want[0][b][want[2][b]], want[1][b][want[2][b]]))


def test_n_scales_with_nms_matches_jax():
    jm, tm = make_model_pair(n_stages=8, seed=2)
    imgs = noise_frames(3, (48, 64), seed=3)
    jfn, _ = jdet.make_batched_detector_boxes(jm, (48, 64), k=1024,
                                              nms_iou=0.4, n_scales=1)
    rj, sj, vj, cj, nj = (np.asarray(a) for a in jfn(jnp.asarray(imgs)))
    tfn, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=1024,
                                            nms_iou=0.4, n_scales=1,
                                            device="cpu")
    rt, st, vt, ct, nt = (a.numpy() for a in tfn(torch.from_numpy(imgs)))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nt, nj)
    assert (vt.sum(1) < ct).any()  # NMS dropped some boxes
    for b in range(len(imgs)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))


def test_n_scales_capped_detector_matches_first_scale():
    """tests/test_parallel.py's contract on the port: n_scales=1 serves
    only the first pyramid level, its box set equal to predict_on_image
    on the first channel_pyramid scale; n_scales past the pyramid's
    depth serves the whole pyramid."""
    from waldboost_tpu_torch.channels import channel_pyramid

    model = port_of(make_model(n_stages=4, shape=(8, 8, 4),
                               opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                         channels="grad_hist")))
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (48, 64)).astype(np.uint8)
    fn, _ = wt.make_batched_detector_boxes(model, img.shape, k=512,
                                           with_n_weak=False, n_scales=1,
                                           device="cpu")
    rects, scores, valid, count, _ = fn(torch.from_numpy(img[None]))
    v = valid[0].numpy()
    got = {(*np.round(rects[0].numpy()[i], 2),
            np.float32(scores[0].numpy()[i])) for i in np.where(v)[0]}
    chns, scale = next(channel_pyramid(img, model.channel_opts,
                                       device="cpu"))
    r, c, h = model.predict_on_image(chns)
    want = {(*np.round(np.asarray(b), 2), np.float32(s))
            for b, s in zip(model.get_boxes(r, c, scale).get(), h)}
    assert got == want and len(got) > 0
    full, packed = wt.make_batched_detector_boxes(model, img.shape,
                                                  device="cpu")
    deep, dpacked = wt.make_batched_detector_boxes(model, img.shape,
                                                   n_scales=99, device="cpu")
    assert len(dpacked.levels) == len(packed.levels)
    for a, b in zip(full(torch.from_numpy(img[None])),
                    deep(torch.from_numpy(img[None]))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [0, -1, True, 1.5, "1"])
def test_n_scales_invalid_raises(bad):
    _, tm = make_model_pair(n_stages=2)
    with pytest.raises(ValueError, match="n_scales"):
        wt.make_batched_detector_boxes(tm, (48, 64), n_scales=bad,
                                       device="cpu")


def test_n_scales_golden_on_cpu():
    """chip_smoke.py phase 7e on the CPU: config 1 (n_scales=1, k=128,
    n_weak off and on) and flagship_synth_64 at n_scales 1 and 4 on a VGA
    noise batch, the scene batch and a coarse-noise batch, against the
    golden's JAX outputs; config 1 keeps windows on the coarse batch."""
    import sys
    sys.path.insert(0, ROOT)
    from chip_smoke import CLI_GOLDEN, n_scales_golden_run, n_scales_key

    _, counts = n_scales_golden_run(wt, torch.device("cpu"),
                                    np.load(CLI_GOLDEN))
    assert len(counts) == 12
    for with_n_weak in (False, True):
        key = n_scales_key("config1_stump_synth_64", 1, with_n_weak,
                           "coarse")
        assert all(c > 0 for c in counts[key]), counts[key]
