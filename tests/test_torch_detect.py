"""PyTorch port, the whole slice on the CPU: make_batched_detector_boxes
(octaves -> planes -> canvas -> cascade -> extraction -> NMS) against the
JAX package's make_batched_detector_boxes: the same survivor count,
n_weak, and box set with bitwise scores, compared after sorting."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu.parallel.detect import \
    make_batched_detector_boxes as jax_detector

import waldboost_tpu_torch as wt

from torch_port_util import make_model_pair, noise_frames, sorted_rows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("nms_iou", [None, 0.4])
@pytest.mark.parametrize("hw,npo,smooth", [((48, 64), 2, 1),
                                           ((96, 128), 2, 0)])
def test_slice_matches_jax(hw, npo, smooth, nms_iou):
    jm, tm = make_model_pair(n_stages=8, seed=2, n_per_oct=npo,
                             smooth=smooth)
    images = noise_frames(3, hw, seed=3)
    fj, _ = jax_detector(jm, hw, k=4096, nms_iou=nms_iou)
    rj, sj, vj, cj, nwj = (np.asarray(a) for a in fj(jnp.asarray(images)))
    ft, packed = wt.make_batched_detector_boxes(tm, hw, k=4096,
                                                nms_iou=nms_iou, device="cpu")
    rt, st, vt, ct, nwt = (a.numpy() for a in ft(torch.from_numpy(images)))
    assert packed.canvas_h > 0 and rt.dtype == np.float32
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nwt, nwj)
    assert (ct > 0).all()
    for b in range(len(images)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))
    if nms_iou is not None:
        assert (vt.sum(1) < ct).any()  # NMS dropped some boxes


def test_slice_matches_jax_on_test_model():
    """The small random model of tests/test_model.py, carried across."""
    from test_model import make_model

    jm = make_model(n_stages=4, shape=(8, 8, 4),
                    opts=dict(shrink=2, n_per_oct=2, smooth=1,
                              channels="grad_hist"))
    tm = wt.model_from_stages(jm.shape, jm.channel_opts,
                              [w.to_stage_dict() for w in jm.classifier],
                              jm.theta, device="cpu")
    images = noise_frames(2, (48, 64), seed=4)
    fj, _ = jax_detector(jm, (48, 64), k=1024, nms_iou=0.4)
    rj, sj, vj, cj, nwj = (np.asarray(a) for a in fj(jnp.asarray(images)))
    ft, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=1024,
                                           nms_iou=0.4, device="cpu")
    rt, st, vt, ct, nwt = (a.numpy() for a in ft(torch.from_numpy(images)))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nwt, nwj)
    for b in range(len(images)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))


def test_overflow_flags_count():
    jm, tm = make_model_pair(n_stages=4, seed=2)
    images = noise_frames(2, (48, 64), seed=3)
    ft, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=4, device="cpu")
    rects, scores, valid, count, _ = ft(torch.from_numpy(images))
    assert rects.shape == (2, 4, 4) and valid.all()
    np.testing.assert_array_equal(count.numpy(), [-1, -1])
    # the kept four are the best four: scores descending
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()


def test_layer_spans_only_under_profiler():
    from contextlib import nullcontext
    from torch.profiler import ProfilerActivity, profile
    from waldboost_tpu_torch.parallel.detect import span
    _, tm = make_model_pair(n_stages=4, seed=2)
    images = torch.from_numpy(noise_frames(2, (48, 64), seed=3))
    ft, _ = wt.make_batched_detector_boxes(tm, (48, 64), k=16, nms_iou=0.5,
                                           device="cpu")
    assert isinstance(span("wb.x"), nullcontext)
    plain = ft(images)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = ft(images)
    names = {e.name for e in prof.events() if e.name.startswith("wb.")}
    assert names == {"wb.octaves", "wb.planes", "wb.channels", "wb.cascade",
                     "wb.extract", "wb.nms"}
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.slow
def test_golden_vga_scene_frames():
    """The committed JAX detections of the flagship on VGA scene frames
    (scripts/make_torch_golden.py): survivor counts, every survivor's box
    and score without NMS, and the kept set with NMS at 0.5, bitwise."""
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "torch_port_vga_golden.npz"))
    model = wt.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"),
                    device="cpu")
    frames = torch.from_numpy(g["frames"])
    raw_split = np.cumsum(g["raw_counts"])[:-1]
    kept_split = np.cumsum(g["kept_counts"])[:-1]
    for nms_iou, rects_ref, scores_ref, split in (
            (None, g["raw_rects"], g["raw_scores"], raw_split),
            (0.5, g["kept_rects"], g["kept_scores"], kept_split)):
        fn, _ = wt.make_batched_detector_boxes(model, (480, 640), k=1024,
                                               nms_iou=nms_iou, device="cpu")
        rects, scores, valid, count, _ = (a.numpy() for a in fn(frames))
        np.testing.assert_array_equal(count, g["raw_counts"])
        for b, (r_ref, s_ref) in enumerate(zip(np.split(rects_ref, split),
                                               np.split(scores_ref, split))):
            np.testing.assert_array_equal(
                sorted_rows(rects[b][valid[b]], scores[b][valid[b]]),
                sorted_rows(r_ref, s_ref))
