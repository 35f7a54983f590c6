"""PyTorch port, the CNN verifier's serving half on the CPU
(``waldboost_tpu_torch/verification.py``, ``convert.verifier_state_dict``,
the rescoring fused into the bucket program), held against the JAX
package's flax verifier (``waldboost_tpu/verification.py``) on
``tests/test_verification.py``'s cases.

Tolerance: the converted module's outputs, and verified scores, within
1e-5 of flax's ``module.apply`` times the outputs' scale (the largest
magnitude, at least 1): the summation orders of the convolutions,
GroupNorm's statistics and the dense products differ, and both sides are
float32 evaluations as far from a float64 one (measured: at most 2.6e-6
of the scale, 7.5e-5 on outputs up to 31).  Boxes and cascade scores are
bitwise.
"""

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from waldboost_tpu import verification as V
from waldboost_tpu.parallel import bucket as jbucket

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import verification as TV
from waldboost_tpu_torch.convert import verifier_state_dict
from waldboost_tpu_torch.parallel.detect import (BucketedDetector,
                                                 make_bucket_detector_boxes)

from test_model import make_model
from test_verification import _toy_pools
from torch_port_util import sorted_rows

torch.set_num_threads(2)

TOL = 1e-5


def assert_close(got, want):
    """``|got - want| <= TOL * max(1, max |want|)`` elementwise."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


OPTS = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist")


def perturbed(params, seed):
    """flax parameters with seeded noise on every leaf (scales and biases
    away from 1 and 0, so a transposed or misplaced leaf shows)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0, 0.3, np.shape(a)).astype(np.float32), params)


def verifier_pair(shape, seed):
    """(flax module, flax params, port module, port state dict)."""
    module, params = V.init_verifier(shape, seed=seed)
    params = perturbed(params, seed)
    return module, params, TV.VerifierCNN(shape), verifier_state_dict(params)


def port_model(jm):
    return wt.model_from_stages(jm.shape, jm.channel_opts,
                                [w.to_stage_dict() for w in jm.classifier],
                                jm.theta, device="cpu")


@pytest.mark.parametrize("shape", [(8, 8, 4), (12, 12, 5), (9, 7, 1),
                                   (24, 24, 4)])
def test_converted_verifier_matches_flax(shape):
    """The flax tree converted (conv kernels (kh, kw, in, out) -> (out,
    in, kh, kw), dense kernels transposed, NHWC flattening, GroupNorm's
    epsilon and fast variance, odd sizes floored by the pool) gives
    flax's outputs."""
    module, params, tmod, state = verifier_pair(shape, seed=sum(shape))
    X = np.random.RandomState(1).rand(37, *shape).astype(np.float32) * 4
    want = np.asarray(module.apply(params, X, deterministic=True))
    tmod.load_state_dict(state)
    with torch.no_grad():
        got = tmod(torch.from_numpy(X)).numpy()
    assert_close(got, want)


def test_verify_scores_matches_jax():
    """verify_scores on 300 windows (JAX pads them to 512; the port runs
    them as they are) and the memoized program."""
    rng = np.random.RandomState(3)
    X0, H0, _, _ = _toy_pools(rng, n=300)
    module, params, tmod, state = verifier_pair((8, 8, 4), seed=3)
    want = V.verify_scores(module, params, X0, H0)
    got = TV.verify_scores(tmod, state, X0, H0, device="cpu")
    assert_close(got, want)
    # a batch's other windows change a score only by rounding (GroupNorm
    # is per window; the convolution's algorithm may follow the batch)
    part = TV.verify_scores(tmod, state, X0[:7], H0[:7], device="cpu")
    assert_close(part, got[:7])
    assert TV.verify_scores(tmod, state, X0[:0], H0[:0],
                            device="cpu").shape == (0,)
    p1 = TV.get_verifier_program(tmod, state, "cpu")
    assert TV.get_verifier_program(tmod, state, "cpu") is p1
    assert TV.get_verifier_program(tmod, dict(state), "cpu") is not p1


def test_detect_and_verify_matches_jax():
    """tests/test_verification.py's fields case: the boxes and cascade
    scores of JAX's detect_and_verify bitwise, the verified scores within
    the tolerance, and the verified scores differ from the cascade's."""
    rng = np.random.RandomState(1)
    jm = make_model(n_stages=3, shape=(8, 8, 4), opts=OPTS)
    tm = port_model(jm)
    module, params, tmod, state = verifier_pair((8, 8, 4), seed=1)
    img = rng.randint(0, 256, (48, 64)).astype(np.uint8)
    want = V.detect_and_verify(img, jm, module, params)
    got = TV.detect_and_verify(img, tm, tmod, state)
    assert len(got) == len(want) == len(tm.detect(img)) > 0
    np.testing.assert_array_equal(got.get(), want.get())
    np.testing.assert_array_equal(got.get_field("cascade_scores"),
                                  want.get_field("cascade_scores"))
    assert_close(got.get_field("scores"), want.get_field("scores"))
    assert not np.allclose(got.get_field("scores"),
                           got.get_field("cascade_scores"))


def test_detect_and_verify_empty_image():
    jm = make_model(n_stages=2, shape=(8, 8, 4), opts=dict(OPTS, smooth=0))
    _, _, tmod, state = verifier_pair((8, 8, 4), seed=2)
    boxes = TV.detect_and_verify(np.zeros((8, 8), np.uint8), port_model(jm),
                                 tmod, state)
    assert len(boxes) == 0 and boxes.has_field("scores")


def test_gather_windows_device_canvas_options():
    """``is_canvas`` crops a given canvas, ``as_device`` keeps the crops
    on the device with their count: the crops of the image path."""
    jm = make_model(n_stages=2, shape=(8, 8, 4), opts=OPTS)
    tm = port_model(jm)
    img = np.random.RandomState(4).randint(0, 256, (48, 64)).astype(np.uint8)
    canvas, _, rs, cs, _ = tm.scan_packed(img)
    crops, k = tm.gather_windows_device(canvas, rs, cs, is_canvas=True,
                                        as_device=True)
    assert isinstance(crops, torch.Tensor) and k == len(rs) > 0
    np.testing.assert_array_equal(crops.numpy(),
                                  tm.gather_windows_device(img, rs, cs))


def test_bucketed_fused_verifier_matches_detect_and_verify():
    """tests/test_verification.py's fused case: BucketedDetector with the
    verifier gives detect_and_verify's boxes and cascade scores bitwise,
    its verified scores within the tolerance, and JAX's fused bucket's
    likewise."""
    rng = np.random.RandomState(5)
    jm = make_model(n_stages=3, shape=(8, 8, 4), opts=OPTS)
    tm = port_model(jm)
    module, params, tmod, state = verifier_pair((8, 8, 4), seed=5)
    imgs = [rng.randint(0, 256, (48, 64)).astype(np.uint8)
            for _ in range(3)]
    got = BucketedDetector(tm, bucket=64, verifier=(tmod, state),
                           device="cpu").detect_many(imgs)
    jgot = jbucket.BucketedDetector(jm, bucket=64,
                                    verifier=(module, params)).detect_many(
                                        imgs)
    for im, bx, jb in zip(imgs, got, jgot):
        ref = TV.detect_and_verify(im, tm, tmod, state)
        assert len(bx) == len(ref) == len(jb) > 0
        for other in (ref, jb):
            a = sorted_rows(bx.get(), bx.get_field("cascade_scores"))
            b = sorted_rows(other.get(), other.get_field("cascade_scores"))
            np.testing.assert_array_equal(a, b)
            a = sorted_rows(bx.get(), bx.get_field("scores"))
            b = sorted_rows(other.get(), other.get_field("scores"))
            np.testing.assert_array_equal(a[:, :4], b[:, :4])
            assert_close(a[:, 4], b[:, 4])


def test_fused_verifier_nms_ranks_by_verified_scores():
    """make_bucket_detector_boxes(verifier=...): six outputs, the scores
    of valid entries ``cnn(X) + H``, the rest the cascade's, and NMS keeps
    what greedy NMS over the verified scores keeps."""
    jm = make_model(n_stages=3, shape=(8, 8, 4), opts=OPTS)
    tm = port_model(jm)
    _, _, tmod, state = verifier_pair((8, 8, 4), seed=6)
    fn, _ = make_bucket_detector_boxes(tm, (64, 64), k=256, nms_iou=0.3,
                                       verifier=(tmod, state), device="cpu")
    imgs = np.random.RandomState(6).randint(0, 256, (2, 64, 64)).astype(
        np.uint8)
    rects, scores, keep, count, n_weak, casc = fn(torch.from_numpy(imgs),
                                                  fn.geometry((48, 64)))
    raw, _ = make_bucket_detector_boxes(tm, (64, 64), k=256, device="cpu")
    r0, s0, v0, c0, _ = raw(torch.from_numpy(imgs), raw.geometry((48, 64)))
    np.testing.assert_array_equal(casc.numpy(), s0.numpy())
    np.testing.assert_array_equal(count.numpy(), c0.numpy())
    assert (keep & ~v0).sum() == 0 and keep.sum() < v0.sum()
    assert not torch.equal(scores[v0], casc[v0])
    assert torch.equal(scores[~v0], casc[~v0])
    from waldboost_tpu_torch.ops.nms import nms
    np.testing.assert_array_equal(keep.numpy(),
                                  (v0 & nms(rects, scores, v0, 0.3)).numpy())


def test_verifier_golden_on_cpu():
    """chip_smoke.py's verifier phase on the CPU, on the second VGA scene
    (tests/data/torch_port_canvas_golden.npz): the golden's flax
    parameters converted; detect_and_verify's boxes and cascade scores
    bitwise JAX's, its verified scores, verify_scores and the fused
    bucket's within the tolerance; the fused bucket equal to
    detect_and_verify then NMS."""
    import chip_smoke as cs
    g = np.load(cs.CANVAS_GOLDEN)
    scenes = cs.canvas_golden_frames(g)[:int(g["n_scenes"])]
    verifier = cs.golden_verifier(wt, g)
    seen, probe = cs.tf32_probe(wt, verifier, "cpu")
    (windows, kept), = cs.verifier_golden_run(wt, "cpu", g, scenes, [1],
                                              verifier)[0]
    probe.remove()
    assert seen and all(p == "highest" for p, _ in seen)
    assert windows > 300 and 0 < kept < windows
