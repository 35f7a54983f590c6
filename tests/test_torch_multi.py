"""PyTorch port, several models over one shared canvas on the CPU:
``wt.detect`` against ``wb.detect`` and ``make_multi_detector_boxes``
against the JAX package's, with models of two window shapes and a
``response_scale``; ``detect_batch`` and ``make_batched_detector`` against
their JAX counterparts; and the errors of the multi-model entry points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu.parallel import detect as jdet

import waldboost_tpu_torch as wt

from torch_port_util import make_model_pair, noise_frames, sorted_rows

torch.set_num_threads(1)

SCALES = [1.0, 0.5, 2.0]


def _three_pairs():
    pairs = [make_model_pair(n_stages=8, shape=(8, 8, 4), seed=20),
             make_model_pair(n_stages=10, shape=(10, 12, 4), seed=21),
             make_model_pair(n_stages=20, shape=(8, 8, 4), seed=28)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _label_rows(boxes):
    rows = np.concatenate([boxes.get(), boxes.get_field("scores")[:, None],
                           boxes.get_field("label")[:, None]], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("hw", [(48, 64), (96, 128)])
def test_detect_multi_matches_jax(hw):
    jms, tms = _three_pairs()
    img = noise_frames(1, hw, seed=23)[0]
    got = wt.detect(img, *tms, response_scale=SCALES)
    want = wb.detect(img, *jms, response_scale=SCALES)
    assert got.get_field("label").dtype == np.int64
    assert {0, 2} <= set(got.get_field("label")) <= {0, 1, 2}
    np.testing.assert_array_equal(_label_rows(got), _label_rows(want))
    for jm, tm in zip(jms, tms):
        assert (tm.n_weak, tm.n_loc) == (jm.n_weak, jm.n_loc)


@pytest.mark.parametrize("nms_iou", [None, 0.4])
def test_multi_detector_boxes_matches_jax(nms_iou):
    jms, tms = _three_pairs()
    images = noise_frames(2, (96, 128), seed=24)
    fj, jpacked = jdet.make_multi_detector_boxes(
        jms, (96, 128), k=2048, nms_iou=nms_iou, response_scale=SCALES)
    want = [np.asarray(a) for a in fj(jnp.asarray(images))]
    ft, packed = wt.make_multi_detector_boxes(
        tms, (96, 128), k=2048, nms_iou=nms_iou, response_scale=SCALES,
        device="cpu")
    got = [a.numpy() for a in ft(torch.from_numpy(images))]
    assert (packed.canvas_h, packed.canvas_w) == (jpacked.canvas_h,
                                                  jpacked.canvas_w)
    rects, scores, valid, label, count, n_weak = got
    jr, js, jv, jl, jc, jnw = want
    assert rects.shape == (2, 3 * 2048, 4) and label.dtype == np.int32
    np.testing.assert_array_equal(count, jc)
    np.testing.assert_array_equal(n_weak, jnw)
    assert (count > 0).all()
    for b in range(2):
        for kix in range(3):
            sel, jsel = valid[b] & (label[b] == kix), jv[b] & (jl[b] == kix)
            np.testing.assert_array_equal(
                sorted_rows(rects[b][sel], scores[b][sel]),
                sorted_rows(jr[b][jsel], js[b][jsel]))


def test_detect_batch_and_batched_detector_match_jax():
    jm, tm = make_model_pair(n_stages=16, seed=25)
    images = noise_frames(3, (48, 64), seed=26)
    for got, want in zip(wt.detect_batch(tm, images, k=8),
                         jdet.detect_batch(jm, images, k=8)):
        np.testing.assert_array_equal(
            sorted_rows(got.get(), got.get_field("scores")),
            sorted_rows(want.get(), want.get_field("scores")))
    for cap in (None, 12):
        ft, _ = wt.make_batched_detector(tm, (48, 64), n_stages_cap=cap,
                                         device="cpu")
        fj, _ = jdet.make_batched_detector(jm, (48, 64), n_stages_cap=cap)
        for a, b in zip(ft(torch.from_numpy(images)),
                        fj(jnp.asarray(images))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(NotImplementedError, match="A11"):
        wt.make_batched_detector(tm, (48, 64), device="cpu", mesh=object())


def test_multi_model_errors():
    jms, tms = _three_pairs()
    img = noise_frames(1, (48, 64), seed=27)[0]
    with pytest.raises(ValueError, match="response_scale"):
        wt.detect(img, *tms, response_scale=[1.0, 2.0])
    with pytest.raises(ValueError):
        wb.detect(img, *jms, response_scale=[1.0, 2.0])
    with pytest.raises(ValueError, match="response_scale"):
        wt.make_multi_detector_boxes(tms, (48, 64), response_scale=[1.0],
                                     device="cpu")
    with pytest.raises(ValueError):
        wt.detect(img[None], *tms)
    empty = wt.detect(np.zeros((6, 6), np.uint8), *tms)
    assert len(empty) == 0 and empty.has_field("label")
    other = wt.model_from_stages((8, 8, 4), dict(tms[0].channel_opts,
                                                 n_per_oct=4),
                                 tms[0].stages, tms[0].theta, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        wt.detect(img, tms[0], other)
    with pytest.raises(ValueError, match="channel options"):
        wt.make_multi_detector_boxes([tms[0], other], (48, 64), device="cpu")
