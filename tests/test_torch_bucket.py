"""PyTorch port, bucketed serving on the CPU: ``BucketedDetector`` and
``bucket_geometry`` (``waldboost_tpu_torch/parallel/bucket.py``) held
against the port's own ``Model.detect`` at the true size and against the
JAX package's ``BucketedDetector``, on the models and sizes of
``tests/test_bucketed.py``.

uint8 frames are bitwise everywhere (exact and fast mode, the FPGA
family).  Exact float frames are bitwise against the port's per-size path
and within PARITY.md's float bound of JAX's bucket.  In fast mode float
frames' planes differ from JAX's bucket's, which come from an f32 matrix
product (``ops/exact.py::resize_lerp_rt``) where the port's float-fast
build lerps per element; the test records that first differing
intermediate and holds the boxes to JAX's own fast-mode bound (measured:
no flip against JAX's fast bucket)."""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_model
from waldboost_tpu.parallel import bucket as jbucket

import waldboost_tpu_torch as wt
from waldboost_tpu_torch.channels import _normalize_opts
from waldboost_tpu_torch.packing import _packed_plan_cached
from waldboost_tpu_torch.parallel import bucket as tbucket
from waldboost_tpu_torch.parallel.detect import (BucketedDetector,
                                                 make_bucket_detector_boxes)

from torch_port_util import make_model_pair, sorted_rows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tests/test_bucketed.py's sizes: three in the (128, 128) bucket of
#: bucket=64, one in (192, 256)
SIZES = [(90, 120), (101, 127), (65, 70), (150, 200)]


def model_pair(channels="grad_hist", smooth=1, shape=(8, 8, 4)):
    """tests/test_bucketed.py's 12-stage flagship cascade and its port."""
    jm = _flagship_model(seed=0, n_stages=12, shape=shape, image_hw=(96, 128),
                         channel_opts=dict(shrink=2, n_per_oct=4,
                                           smooth=smooth, channels=channels))
    tm = wt.model_from_stages(jm.shape, jm.channel_opts,
                              [w.to_stage_dict() for w in jm.classifier],
                              jm.theta, device="cpu")
    return jm, tm


def random_pair(seed=2, n_per_oct=4):
    """A random cascade that keeps thousands of windows of noise."""
    return make_model_pair(n_stages=8, seed=seed, n_per_oct=n_per_oct)


def box_set(boxes):
    return set(map(tuple, np.concatenate(
        [boxes.get(), boxes.get_field("scores")[:, None]], 1)))


def frames_at(sizes, seed, floats=False):
    rng = np.random.RandomState(seed)
    out = []
    for hw in sizes:
        im = rng.randint(0, 256, hw)
        if floats:
            im = im + rng.rand(*hw)
        out.append(im.astype(np.float32 if floats else np.uint8))
    return out


@contextlib.contextmanager
def jax_fast():
    """The JAX package's WB_SERVING_MODE=fast, read when a detector is
    built."""
    prev = os.environ.get("WB_SERVING_MODE")
    os.environ["WB_SERVING_MODE"] = "fast"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("WB_SERVING_MODE")
        else:
            os.environ["WB_SERVING_MODE"] = prev


# -- true size ------------------------------------------------------------

@pytest.mark.parametrize("which", ["flagship", "random"])
def test_bucketed_true_size_uint8(which):
    """Four sizes in two buckets: two set-ups, each image's boxes and
    scores bitwise the port's Model.detect and JAX's BucketedDetector; a
    novel size inside a known bucket costs no set-up."""
    jm, tm = model_pair() if which == "flagship" else random_pair()
    k = 256 if which == "flagship" else 8192
    det = BucketedDetector(tm, bucket=64, k=k, device="cpu")
    imgs = frames_at(SIZES, seed=2)
    out = det.detect_many(imgs)
    assert det.compiles == 2
    jout = jbucket.BucketedDetector(jm, bucket=64, k=k).detect_many(imgs)
    for img, got, want in zip(imgs, out, jout):
        ref = box_set(tm.detect(img))
        assert box_set(got) == ref == box_set(want), img.shape
        if which == "random":
            assert len(ref) > 100
        rr = got.get()
        assert (rr[:, 2] <= img.shape[1] + 1e-3).all()
        assert (rr[:, 3] <= img.shape[0] + 1e-3).all()
    det.detect(imgs[1])
    novel = frames_at([(77, 99)], seed=3)[0]
    assert box_set(det.detect(novel)) == box_set(tm.detect(novel))
    assert det.compiles == 2


def test_bucket_program_ignores_padding():
    """The program reads only the real-size crop of a padded batch:
    garbage in the padding changes nothing."""
    _, tm = random_pair()
    fn, packed = make_bucket_detector_boxes(tm, (128, 128), k=8192,
                                            device="cpu")
    geom = fn.geometry((90, 120))
    img = frames_at([(90, 120)], seed=4)[0]
    batch = np.random.RandomState(5).randint(0, 256, (2, 128, 128)) \
        .astype(np.uint8)
    batch[:, :90, :120] = img
    clean = np.zeros_like(batch)
    clean[:, :90, :120] = img
    a = [x.numpy() for x in fn(torch.from_numpy(batch), geom)]
    b = [x.numpy() for x in fn(torch.from_numpy(clean), geom)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    want = tm.detect(img)
    rects, scores, valid, count, _ = a
    assert count[0] == len(want)
    np.testing.assert_array_equal(
        sorted_rows(rects[0][valid[0]], scores[0][valid[0]]),
        sorted_rows(want.get(), want.get_field("scores")))


def test_bucketed_sizes_lru(monkeypatch):
    """Each bucket keeps the device tables of its MAX_SIZES most recent
    sizes; an evicted size is rebuilt on its next frame, with the same
    boxes."""
    _, tm = random_pair()
    monkeypatch.setattr(BucketedDetector, "MAX_SIZES", 2)
    det = BucketedDetector(tm, bucket=64, k=8192, device="cpu")
    imgs = frames_at(SIZES[:3], seed=8)
    first = det.detect_many(imgs)
    sizes = det._sizes[(128, 128)]
    assert list(sizes) == [SIZES[1], SIZES[2]]
    again = det.detect(imgs[0])
    assert list(sizes) == [SIZES[2], SIZES[0]]
    assert box_set(again) == box_set(first[0]) == box_set(tm.detect(imgs[0]))
    assert det.compiles == 1


@pytest.mark.parametrize("which", ["flagship", "random"])
def test_bucketed_float_frames(which):
    """Exact float frames: bitwise the port's Model.detect at the true
    size; against JAX's bucket within PARITY.md's float bound (at most
    0.5% of the union flips; measured: none)."""
    jm, tm = model_pair() if which == "flagship" else random_pair()
    k = 256 if which == "flagship" else 8192
    det = BucketedDetector(tm, bucket=64, k=k, device="cpu")
    jdet = jbucket.BucketedDetector(jm, bucket=64, k=k)
    imgs = frames_at(SIZES[:3], seed=5, floats=True)
    for img, got, want in zip(imgs, det.detect_many(imgs),
                              jdet.detect_many(imgs)):
        got, want = box_set(got), box_set(want)
        assert got == box_set(tm.detect(img)), img.shape
        flips = len(got ^ want)
        print(f"{which} float {img.shape}: {len(got)} boxes, {flips} flips "
              f"against JAX's bucket")
        assert flips <= 0.005 * max(len(got | want), 1)
    assert det.compiles == 1


def test_bucketed_mixed_types_group_apart():
    """uint8 and float frames of one size in one call: each is served as
    its own type."""
    _, tm = random_pair()
    u8 = frames_at([(90, 120)], seed=6)[0]
    f32 = u8.astype(np.float32) + 0.25
    det = BucketedDetector(tm, bucket=64, k=8192, device="cpu")
    got = det.detect_many([u8, f32])
    assert box_set(got[0]) == box_set(tm.detect(u8))
    assert box_set(got[1]) == box_set(tm.detect(f32))


# -- fast mode --------------------------------------------------------------

def test_bucketed_fast_uint8_matches_jax():
    """Fast mode on uint8 frames follows JAX's bucket: B2's exact canvas
    rounded to bfloat16 and walked by B3f (no B2f); bitwise."""
    jm, tm = random_pair()
    imgs = frames_at(SIZES, seed=7)
    with jax_fast():
        jdet = jbucket.BucketedDetector(jm, bucket=64, k=8192)
        want = jdet.detect_many(imgs)
    det = BucketedDetector(tm, bucket=64, k=8192, fast=True, device="cpu")
    for img, got, ref in zip(imgs, det.detect_many(imgs), want):
        assert len(ref) > 100
        assert box_set(got) == box_set(ref), img.shape


def test_bucketed_fast_float_bound():
    """Fast mode on float frames: the port's float-fast planes and B2f
    against JAX's bucket, whose float planes come from an f32 matrix
    product (``resize_lerp_rt``).  The first differing intermediate is
    the planes (checked on one level here); the boxes are held to JAX's
    own fast-mode bound against the exact bucket
    (tests/test_bucketed.py:93: flips at most a quarter of the exact
    set).  Measured: 3,552 boxes, no flip against JAX's fast bucket,
    152 against the exact one; the level's planes differ in 3,114 of
    7,104 values, by at most 3.1e-5."""
    from waldboost_tpu.ops.exact import resize_lerp_rt
    from waldboost_tpu_torch import channels as tch
    from waldboost_tpu_torch.polyphase import float_plane_tables
    from waldboost_tpu_torch.ops import planes as tpl

    jm, tm = random_pair()
    img = frames_at([(90, 115)], seed=6, floats=True)[0]
    exact = box_set(BucketedDetector(tm, bucket=64, k=8192,
                                     device="cpu").detect(img))
    fast = box_set(BucketedDetector(tm, bucket=64, k=8192, fast=True,
                                    device="cpu").detect(img))
    with jax_fast():
        jfast = box_set(jbucket.BucketedDetector(jm, bucket=64,
                                                 k=8192).detect(img))
    print(f"fast float: port {len(fast)} boxes, JAX {len(jfast)}, "
          f"{len(fast ^ jfast)} flips; exact {len(exact)}, "
          f"{len(fast ^ exact)} flips")
    assert len(exact ^ fast) <= 0.25 * max(len(exact), 1)
    assert len(jfast ^ fast) <= 0.25 * max(len(jfast), 1)
    # the first intermediate: one level's planes
    _, n_per_oct, _, cf = _normalize_opts(tm.channel_opts)
    packed = tbucket.bucket_geometry((128, 128), img.shape, (8, 8), 2,
                                     n_per_oct, cf.name)
    tables = float_plane_tables(packed, packed.halo, img.shape)
    octs = tch.level_octaves(torch.from_numpy(img[None]),
                             len(tables.oct_hw))
    planes = tpl.planes_float_fast(tpl.octave_buffer(octs),
                                   tpl.FloatPlaneOperands.build(tables,
                                                                "cpu"),
                                   torch.float32)[0].numpy()
    pl = packed.levels[1]
    lv = pl.level
    g = jbucket.bucket_geometry((128, 128), img.shape, (8, 8), 2, n_per_oct,
                                0, cf.name, False)
    jl = [i for i, p in enumerate(
        _jax_bucket_plan(jm, (128, 128)).levels)
        if p.plan_index == pl.plan_index][0]
    want = np.asarray(resize_lerp_rt(jnp.asarray(octs[lv.octave][0].numpy()),
                                     g[f"r{jl}"], g[f"c{jl}"]))
    h2 = packed.halo
    want = want[h2:h2 + lv.height, h2:h2 + lv.width]
    blk = planes[:, :, pl.y:pl.y + lv.height // 2, pl.x:pl.x + lv.width // 2]
    got = blk.transpose(2, 0, 3, 1).reshape(lv.height, lv.width)
    differ = int((got != want).sum())
    print(f"level {pl.plan_index} planes: {differ} of {got.size} differ, "
          f"max abs {np.abs(got - want).max()}")
    assert differ > 0 and np.abs(got - want).max() < 1e-3


def _jax_bucket_plan(jm, bucket_hw):
    from waldboost_tpu.model import _packed_plan_cached as jplan
    m, n, _ = jm.shape
    return jplan(bucket_hw[0], bucket_hw[1], 2,
                 int(jm.channel_opts["n_per_oct"]), (m, n), halo=1)


# -- cost, FPGA, overflow -----------------------------------------------------

def test_bucketed_track_cost_matches_detect():
    """track_cost folds each image's n_weak and scanned windows into the
    model's counters as Model.detect does."""
    _, tm = model_pair()
    img = frames_at([(45, 60)], seed=9)[0]
    tm.reset()
    ref = box_set(tm.detect(img))
    want = (tm.n_weak, tm.n_loc, tm.cost_stats()["n_images"])
    tm.reset()
    det = BucketedDetector(tm, bucket=32, k=128, track_cost=True,
                           device="cpu")
    assert box_set(det.detect(img)) == ref
    assert (tm.n_weak, tm.n_loc, tm.cost_stats()["n_images"]) == want
    assert want[0] > 0 and want[1] > 0


FPGA_KINDS = [("grad_hist_4_u1", 4), ("grad_mag_u1", 1),
              ("grad_hist_4_u1+grad_mag_u1", 5)]


@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("channels,C", FPGA_KINDS)
def test_bucketed_fpga_matches_jax(channels, C, smooth):
    """FPGA models (halo 0, B5 on the card) at two sizes in one bucket:
    bitwise the port's and JAX's Model.detect at the true size, and JAX's
    bucket for each single kind.  JAX's bucket misses its own contract
    for the composite: its image-space canvas casts each part to float32
    before the 2x2 pool (``channels.py::compose_channel_functions``'
    ``canvas_fn``), so the pool neither wraps nor truncates and 3,366 -
    4,464 boxes differ from its Model.detect here (ROADMAP §C)."""
    jm, tm = make_model_pair(n_stages=6, shape=(8, 8, C), seed=5,
                             n_per_oct=2, smooth=smooth, thr_max=40.0,
                             channels=channels)
    imgs = frames_at([(90, 120), (101, 127)], seed=10)
    det = BucketedDetector(tm, bucket=64, k=8192, device="cpu")
    jdet = jbucket.BucketedDetector(jm, bucket=64, k=8192)
    for img, got, ref in zip(imgs, det.detect_many(imgs),
                             jdet.detect_many(imgs)):
        want = box_set(jm.detect(img))
        assert len(want) > 1000
        assert box_set(got) == want == box_set(tm.detect(img))
        if "+" not in channels:
            assert box_set(ref) == want
    assert det.compiles == 1


def test_bucketed_overflow_falls_back():
    """More survivors than k: the program flags count -1 and the front end
    returns Model.detect's boxes (then NMS), on the same device."""
    _, tm = random_pair()
    img = frames_at([(90, 120)], seed=11)[0]
    fn, _ = make_bucket_detector_boxes(tm, (128, 128), k=4, device="cpu")
    batch = np.zeros((1, 128, 128), np.uint8)
    batch[0, :90, :120] = img
    assert int(fn(torch.from_numpy(batch), fn.geometry((90, 120)))[3][0]) == -1
    det = BucketedDetector(tm, bucket=64, k=4, device="cpu")
    assert box_set(det.detect(img)) == box_set(tm.detect(img))
    nms = BucketedDetector(tm, bucket=64, k=4, nms_iou=0.5, device="cpu")
    want = wt.bbx.non_max_suppression(tm.detect(img), iou_threshold=0.5)
    assert box_set(nms.detect(img)) == box_set(want)


def test_bucketed_nms_matches_batched_detector():
    """With nms_iou the bucket keeps what make_batched_detector_boxes keeps
    at the true size."""
    _, tm = random_pair()
    img = frames_at([(90, 120)], seed=12)[0]
    got = BucketedDetector(tm, bucket=64, k=8192, nms_iou=0.5,
                           device="cpu").detect(img)
    fn, _ = wt.make_batched_detector_boxes(tm, img.shape, k=8192,
                                           nms_iou=0.5, device="cpu")
    rects, scores, valid, _, _ = (a.numpy()
                                  for a in fn(torch.from_numpy(img[None])))
    np.testing.assert_array_equal(
        sorted_rows(got.get(), got.get_field("scores")),
        sorted_rows(rects[0][valid[0]], scores[0][valid[0]]))


# -- geometry ---------------------------------------------------------------

@pytest.mark.parametrize("real_hw", [(90, 120), (65, 70), (128, 128),
                                     (17, 17)])
def test_bucket_geometry_matches_jax(real_hw):
    """Each real level sits inside its bucket slot at the bucket's
    placement (plane row = band start + row in band = y - halo/2); the
    valid, level-id and interior masks equal JAX's bucket_geometry
    arrays and the inverse scales are bitwise JAX's."""
    from waldboost_tpu_torch.polyphase import _level_rows
    jm, tm = model_pair()
    _, n_per_oct, _, cf = _normalize_opts(tm.channel_opts)
    bucket_hw, window = (128, 128), (8, 8)
    packed = tbucket.bucket_geometry(bucket_hw, real_hw, window, 2,
                                     n_per_oct, cf.name)
    bplan = _packed_plan_cached(128, 128, 2, n_per_oct, window, halo=1)
    slots = {pl.plan_index: pl for pl in bplan.levels}
    he2 = packed.halo // 2
    rows = _level_rows(packed, he2, packed.canvas_h)
    for li, pl in enumerate(packed.levels):
        slot = slots[pl.plan_index]
        assert (pl.y, pl.x) == (slot.y, slot.x)
        assert (pl.level.height + 2 * packed.halo) // 2 \
            <= (slot.level.height + 2 * packed.halo) // 2
        assert (pl.level.width + 2 * packed.halo) // 2 \
            <= (slot.level.width + 2 * packed.halo) // 2
        assert rows[li] == pl.y - he2
    g = jbucket.bucket_geometry(bucket_hw, real_hw, window, 2, n_per_oct, 1,
                                cf.name, True)
    jplan = _jax_bucket_plan(jm, bucket_hw)
    # JAX's level ids index the bucket's levels; the port keeps the real ones
    to_port = {jl: li for li, pl in enumerate(packed.levels)
               for jl, jp in enumerate(jplan.levels)
               if jp.plan_index == pl.plan_index}
    np.testing.assert_array_equal(packed.valid_mask(window), g["valid"])
    lid, iscales = packed.level_maps(window)
    jlid = g["lid"][:lid.shape[0], :lid.shape[1]]
    mapped = np.vectorize(lambda v: to_port.get(v, -1))(jlid)
    np.testing.assert_array_equal(lid, mapped)
    np.testing.assert_array_equal(packed.smooth_interior_mask(),
                                  g["interior"])
    for jl, li in to_port.items():
        assert iscales[li].tobytes() == g["iscales"][jl].tobytes()
    if real_hw == (17, 17):
        assert not packed.levels


# -- the committed golden -----------------------------------------------------

def test_bucket_golden():
    """tests/data/torch_port_bucket_golden.npz (JAX's BucketedDetector,
    flagship_synth_64, bucket 128, k 1024, NMS 0.5): the kept boxes and
    scores of its four frames bitwise, two set-ups."""
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "torch_port_bucket_golden.npz"))
    model = wt.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"),
                    device="cpu")
    det = BucketedDetector(model, bucket=int(g["bucket"]), k=int(g["k"]),
                           nms_iou=float(g["nms_iou"]), device="cpu")
    keys = sorted(k[len("frame_"):] for k in g.files
                  if k.startswith("frame_"))
    got = det.detect_many([g[f"frame_{k}"] for k in keys])
    for key, bx in zip(keys, got):
        want = g[f"kept_{key}"]
        np.testing.assert_array_equal(
            sorted_rows(bx.get(), bx.get_field("scores")),
            sorted_rows(want[:, :4], want[:, 4]))
    assert det.compiles == 2
