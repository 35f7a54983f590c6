"""PyTorch port, the image-space channel canvas on the CPU: shrink 1 and
channel functions with no polyphase form (``grad_mag``, ``grad_hist+
grad_mag``), ``waldboost_tpu_torch/ops/image_canvas.py``, held against the
JAX package's ``polyphase._channel_canvas_batch`` (its XLA
``_channel_canvas_fast`` per image) and the serving entries built on it.

Tolerances (PARITY.md): uint8 grad_hist canvases, survivors, boxes and
scores bitwise, except canvas values below 2**-30 on both sides (the
exact-cancellation lines, PARITY.md 1c: no pool absorbs them at shrink
1); FPGA kinds bitwise; float grad_hist bitwise on these frames too (the
f32 resize rows then columns, the f64 prefilter and projection where JAX
runs its double-float chain).  grad_mag follows
``tests/oracle.py::grad_mag``'s arithmetic (float64 sums in the triangle
filter, a correctly rounded root) and equals it bitwise on uint8 frames;
JAX sums its triangle filter in float32, so its canvases are held within
16 ULP (measured: 4) and its boxes within 0.5% flips.  JAX's composite
FPGA canvas at shrink 1 and smooth 1 does not truncate the smooth (its
``canvas_fn`` casts the parts to float32); the port follows the per-level
reference, JAX's ``channel_pyramid``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from __graft_entry__ import _flagship_model
from waldboost_tpu import polyphase as jpoly
from waldboost_tpu.channels import channel_pyramid as jchannel_pyramid
from waldboost_tpu.channels import resolve_channel_function as jresolve
from waldboost_tpu.ops.warp import reflect_halos
from waldboost_tpu.packing import _packed_plan_cached as jplan
from waldboost_tpu.parallel import bucket as jbucket
from waldboost_tpu.parallel import detect as jdetect
from waldboost_tpu import utils as jutils

import oracle
import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import utils as tutils
from waldboost_tpu_torch.canvas import channel_canvas
from waldboost_tpu_torch.ops import image_canvas as tic
from waldboost_tpu_torch.packing import _packed_plan_cached as tplan
from waldboost_tpu_torch.parallel.detect import BucketedDetector

from test_torch_training import Forced, as_port_tree
from torch_port_util import sorted_rows

torch.set_num_threads(2)

HW = (96, 128)
CPU = torch.device("cpu")


def ulps(a, b) -> np.ndarray:
    """Elementwise distance of two float32 arrays in units in the last
    place (on the ordered integer line of the float32 bits)."""
    def line(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(line(a) - line(b))


def frames(n, hw=HW, seed=0, floats=False):
    rng = np.random.RandomState(seed)
    im = rng.randint(0, 256, (n,) + tuple(hw))
    if floats:
        return (im + rng.rand(*im.shape)).astype(np.float32)
    return im.astype(np.uint8)


def canvases(chans, shrink, smooth, imgs, window=(8, 8), n_per_oct=2):
    """(JAX's, the port's) (B, C, Hc, Wc) canvases and the port's plan."""
    jcf, tcf = jresolve(chans), tch.resolve_channel_function(chans)
    h, w = imgs.shape[1:]
    jpk = jplan(h, w, shrink, n_per_oct, window, halo=jcf.halo)
    tpk = tplan(h, w, shrink, n_per_oct, window, halo=tcf.halo)
    assert (jpk.canvas_h, jpk.canvas_w, jpk.halo) == \
        (tpk.canvas_h, tpk.canvas_w, tpk.halo)
    want = np.asarray(jpoly._channel_canvas_batch(
        jnp.asarray(imgs), shrink, n_per_oct, smooth, jcf, jpk))
    step = channel_canvas(tpk, (h, w), smooth, tcf, CPU)
    assert step.image_space
    return want, step(torch.from_numpy(imgs)).numpy(), tpk


CASES = [("grad_hist", 1), ("grad_mag", 1), ("grad_mag", 2),
         ("grad_hist+grad_mag", 2), ("grad_mag+grad_hist", 1),
         ("grad_hist_4_u1", 1), ("grad_mag_u1", 1)]


@pytest.mark.parametrize("floats", [False, True], ids=["uint8", "float"])
@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("chans,shrink", CASES)
def test_image_canvas_matches_jax(chans, shrink, smooth, floats):
    imgs = frames(2, seed=3 + smooth, floats=floats)
    want, got, packed = canvases(chans, shrink, smooth, imgs)
    assert got.shape == want.shape and got.dtype == np.float32
    tiny = (np.abs(want) < 2.0 ** -30) & (np.abs(got) < 2.0 ** -30)
    u = ulps(want, got)
    if chans in ("grad_mag", "grad_hist+grad_mag", "grad_mag+grad_hist"):
        assert u[~tiny].max() <= 16, u[~tiny].max()
        # a composite's grad_hist channels are held as grad_hist's
        hist = {"grad_hist+grad_mag": slice(0, 4),
                "grad_mag+grad_hist": slice(1, 5)}.get(chans)
        if hist is None:
            return
        want, got, tiny = want[:, hist], got[:, hist], tiny[:, hist]
    assert np.array_equal(want[~tiny], got[~tiny])


def test_composite_fpga_smooth_truncates_as_reference():
    """At shrink 1 and smooth 1 the port's composite FPGA canvas equals
    JAX's per-level pyramid (the reference's uint8 smooth), level by
    level; JAX's image-space canvas does not truncate there."""
    chans = "grad_hist_4_u1+grad_mag_u1"
    img = frames(1, seed=5)
    want, got, packed = canvases(chans, 1, 1, img, window=(0, 0))
    opts = dict(shrink=1, n_per_oct=2, smooth=1, channels=chans)
    levels = list(jchannel_pyramid(img[0], opts))
    assert len(levels) == len(packed.levels)
    for (chns, _), pl in zip(levels, packed.levels):
        lv = pl.level
        cut = got[0, :, pl.y:pl.y + lv.out_height, pl.x:pl.x + lv.out_width]
        np.testing.assert_array_equal(cut.transpose(1, 2, 0), chns)
    # JAX's image-space canvas keeps the smooth's fractions
    assert (want != np.floor(want)).any() and not np.array_equal(want, got)


@pytest.mark.parametrize("shrink,smooth", [(1, 0), (1, 1), (2, 1)])
def test_grad_mag_matches_oracle(shrink, smooth):
    """uint8 frames: every level of the port's grad_mag canvas equals
    tests/oracle.py's per-level chain bitwise."""
    img = frames(1, seed=11)
    tcf = tch.resolve_channel_function("grad_mag")
    packed = tplan(*HW, shrink, 2, (0, 0), halo=tcf.halo)
    got = channel_canvas(packed, HW, smooth, tcf, CPU)(
        torch.from_numpy(img)).numpy()[0]
    opts = dict(shrink=shrink, n_per_oct=2, smooth=smooth,
                channels=oracle.grad_mag)
    levels = list(oracle.channel_pyramid(img[0], opts))
    assert len(levels) == len(packed.levels)
    for (chns, _), pl in zip(levels, packed.levels):
        lv = pl.level
        cut = got[:, pl.y:pl.y + lv.out_height, pl.x:pl.x + lv.out_width]
        np.testing.assert_array_equal(cut.transpose(1, 2, 0), chns)


def test_reflect_map_matches_reflect_halos():
    """The gather of :func:`reflect_map` equals JAX's ``reflect_halos``,
    also where a level is narrower than its halo (only ``min(halo, h,
    w)`` rows and columns are reflected)."""
    rng = np.random.RandomState(4)
    canvas = rng.rand(40, 60).astype(np.float32)
    regions = ((8, 8, 12, 20, 6), (8, 40, 4, 5, 6), (28, 10, 7, 30, 2))
    want = np.asarray(reflect_halos(jnp.asarray(canvas), regions))
    got = canvas.reshape(-1)[tic.reflect_map(canvas.shape, regions)]
    np.testing.assert_array_equal(got.reshape(canvas.shape), want)


def model_pair(chans, shrink, shape, n_stages=8, smooth=1, n_per_oct=2,
               seed=0):
    """A calibrated seeded cascade (``__graft_entry__._flagship_model``)
    and its port on the CPU."""
    jm = _flagship_model(seed=seed, n_stages=n_stages, shape=shape,
                         image_hw=HW, calib_q=0.3,
                         channel_opts=dict(shrink=shrink, n_per_oct=n_per_oct,
                                           smooth=smooth, channels=chans))
    tm = wt.model_from_stages(jm.shape, jm.channel_opts,
                              [w.to_stage_dict() for w in jm.classifier],
                              jm.theta, device="cpu")
    return jm, tm


def rows(boxes):
    return sorted_rows(boxes.get(), boxes.get_field("scores"))


def flips(a, b) -> float:
    """Share of boxes in one set and not the other (by rectangle)."""
    sa, sb = (set(map(tuple, x.get())) for x in (a, b))
    return len(sa ^ sb) / max(len(sa | sb), 1)


MODELS = [("grad_hist", 1, (8, 8, 4)), ("grad_mag", 2, (8, 8, 1)),
          ("grad_hist+grad_mag", 2, (8, 8, 5)), ("grad_mag", 1, (8, 8, 1))]


@pytest.mark.parametrize("chans,shrink,shape", MODELS)
def test_model_api_matches_jax(chans, shrink, shape):
    """Model.detect, detect_topk, scan_packed and the survivor counters:
    bitwise JAX's for grad_hist at shrink 1, within 0.5% box flips for
    grad_mag (whose scores differ by ULPs)."""
    jm, tm = model_pair(chans, shrink, shape)
    exact = "grad_mag" not in chans
    for img in frames(2, seed=21):
        jb, tb = jm.detect(img), tm.detect(img)
        assert len(tb) > 0
        if exact:
            np.testing.assert_array_equal(rows(tb), rows(jb))
        else:
            assert flips(jb, tb) <= 0.005, flips(jb, tb)
        jk = jm.detect_topk(img, k=64, nms_iou=0.5)
        tk = tm.detect_topk(img, k=64, nms_iou=0.5)
        if exact:
            np.testing.assert_array_equal(rows(tk), rows(jk))
        else:
            assert flips(jk, tk) <= 0.05
        _, _, rs, cs, hs = tm.scan_packed(img)
        _, _, jrs, jcs, jhs = jm.scan_packed(img)
        assert len(rs) == len(tb)
        if exact:
            for a, b in ((rs, jrs), (cs, jcs), (hs, jhs)):
                np.testing.assert_array_equal(a, np.asarray(b))
    if exact:
        for k in ("n_weak", "n_loc", "n_images"):
            assert tm.cost_stats()[k] == jm.cost_stats()[k], k


@pytest.mark.parametrize("chans,shrink,shape", MODELS[:3])
def test_batched_detector_matches_jax(chans, shrink, shape):
    jm, tm = model_pair(chans, shrink, shape)
    imgs = frames(3, seed=31)
    jfn, jpk = jdetect.make_batched_detector_boxes(jm, HW, k=256,
                                                   nms_iou=0.5)
    tfn, tpk = wt.make_batched_detector_boxes(tm, HW, k=256, nms_iou=0.5,
                                              device="cpu")
    assert (jpk.canvas_h, jpk.canvas_w) == (tpk.canvas_h, tpk.canvas_w)
    jr = [np.asarray(a) for a in jfn(jnp.asarray(imgs))]
    tr = [a.numpy() for a in tfn(torch.from_numpy(imgs))]
    exact = "grad_mag" not in chans
    if exact:
        np.testing.assert_array_equal(tr[3], jr[3])   # survivor counts
        np.testing.assert_array_equal(tr[4], jr[4])   # n_weak
    for b in range(len(imgs)):
        t = sorted_rows(tr[0][b][tr[2][b]], tr[1][b][tr[2][b]])
        j = sorted_rows(jr[0][b][jr[2][b]], jr[1][b][jr[2][b]])
        if exact:
            np.testing.assert_array_equal(t, j)
        else:
            ts, js = set(map(tuple, t[:, :4])), set(map(tuple, j[:, :4]))
            assert len(ts ^ js) <= max(1, 0.005 * len(ts | js))


@pytest.mark.parametrize("chans,shrink,shape", MODELS[:2])
def test_bucketed_matches_detect_and_jax(chans, shrink, shape):
    """BucketedDetector at two sizes of one bucket: every survivor equals
    the port's Model.detect at the true size, and JAX's bucket (bitwise
    for grad_hist at shrink 1)."""
    jm, tm = model_pair(chans, shrink, shape)
    rng = np.random.RandomState(7)
    imgs = [rng.randint(0, 256, hw).astype(np.uint8)
            for hw in ((87, 113), (96, 128))]
    tdet = BucketedDetector(tm, bucket=64, k=4096, device="cpu")
    jdet = jbucket.BucketedDetector(jm, bucket=64, k=4096)
    for img, tb, jb in zip(imgs, tdet.detect_many(imgs),
                           jdet.detect_many(imgs)):
        np.testing.assert_array_equal(rows(tb), rows(tm.detect(img)))
        if "grad_mag" in chans:
            assert flips(jb, tb) <= 0.005
        else:
            np.testing.assert_array_equal(rows(tb), rows(jb))
    assert tdet.compiles == 1


#: fast mode on the image-space canvas (shrink 1, grad_mag): the port's
#: canvas is the exact one rounded to bfloat16 and walked by B3f, as JAX's
#: batched detector's ``_channel_canvas_fast``
FAST_MODELS = [("grad_hist", 1, (8, 8, 4)), ("grad_mag", 2, (8, 8, 1))]


@pytest.mark.parametrize("with_n_weak", [False, True])
@pytest.mark.parametrize("floats", [False, True], ids=["uint8", "float"])
@pytest.mark.parametrize("chans,shrink,shape", FAST_MODELS)
def test_fast_batched_detector_matches_jax(chans, shrink, shape, floats,
                                           with_n_weak):
    """make_batched_detector_boxes(fast=True) against JAX's under
    WB_SERVING_MODE=fast with its Pallas channel backend (as the fast
    goldens): counts, n_weak, kept boxes and scores bitwise for grad_hist
    at shrink 1 (with n_weak counted JAX walks the exact canvas, without
    it the canvas rounded to bfloat16); grad_mag within its exact-mode
    bound (0.5% box flips: JAX's float32 triangle sums, PARITY.md)."""
    from test_torch_fast import jax_fast
    jm, tm = model_pair(chans, shrink, shape)
    imgs = frames(3, seed=41, floats=floats)
    with jax_fast():
        jfn, _ = jdetect.make_batched_detector_boxes(
            jm, HW, k=256, nms_iou=0.5, with_n_weak=with_n_weak)
        jr = [np.asarray(a) for a in jfn(jnp.asarray(imgs))]
    tfn, _ = wt.make_batched_detector_boxes(tm, HW, k=256, nms_iou=0.5,
                                            with_n_weak=with_n_weak,
                                            device="cpu", fast=True)
    tr = [a.numpy() for a in tfn(torch.from_numpy(imgs))]
    exact = "grad_mag" not in chans
    assert tr[2].any()                            # kept boxes
    if exact:
        np.testing.assert_array_equal(tr[3], jr[3])   # survivor counts
        np.testing.assert_array_equal(tr[4], jr[4])   # n_weak
    for b in range(len(imgs)):
        t = sorted_rows(tr[0][b][tr[2][b]], tr[1][b][tr[2][b]])
        j = sorted_rows(jr[0][b][jr[2][b]], jr[1][b][jr[2][b]])
        if exact:
            np.testing.assert_array_equal(t, j)
        else:
            ts, js = set(map(tuple, t[:, :4])), set(map(tuple, j[:, :4]))
            assert len(ts ^ js) <= max(1, 0.005 * len(ts | js))


#: BASELINE.md's fast-mode box flips against the exact path: uint8 noise
#: frames 3 of 68 (4.4%), float frames with f32 planes 71 of 916 (7.8%)
FAST_FLIPS = {False: 0.044, True: 0.078}


@pytest.mark.parametrize("chans,shrink,shape", FAST_MODELS)
def test_fast_bucketed_matches_jax(chans, shrink, shape):
    """BucketedDetector(fast=True) on uint8 and float frames at two sizes
    of one bucket: every survivor equals the port's fast batched detector
    (the bfloat16 walk) at the true size, and JAX's fast bucket (its
    grad_hist a plain f32 chain on float frames) within BASELINE.md's
    fast-mode flips."""
    from test_torch_fast import jax_fast
    jm, tm = model_pair(chans, shrink, shape)
    rng = np.random.RandomState(11)
    u8 = [rng.randint(0, 256, hw).astype(np.uint8)
          for hw in ((87, 113), (96, 128))]
    f32 = [(im + rng.rand(*im.shape)).astype(np.float32) for im in u8]
    tdet = BucketedDetector(tm, bucket=64, k=4096, device="cpu", fast=True)
    jdet = jbucket.BucketedDetector(jm, bucket=64, k=4096)
    # one frame type a call: JAX's bucket groups frames by size alone
    got = tdet.detect_many(u8) + tdet.detect_many(f32)
    with jax_fast():
        want = jdet.detect_many(u8) + jdet.detect_many(f32)
    for img, tb, jb in zip(u8 + f32, got, want):
        # the bucket walks the bfloat16 canvas (its B3f counts n_weak too)
        fn, _ = wt.make_batched_detector_boxes(tm, img.shape, k=4096,
                                               with_n_weak=False,
                                               device="cpu", fast=True)
        r, sc, v = (a.numpy()[0] for a in fn(torch.from_numpy(img[None]))[:3])
        np.testing.assert_array_equal(rows(tb), sorted_rows(r[v], sc[v]))
        assert len(tb) > 0
        assert flips(jb, tb) <= FAST_FLIPS[img.dtype == np.float32], \
            flips(jb, tb)
    assert tdet.compiles == 1


def test_bucketed_grad_mag_midpipeline_reflect():
    """tests/test_bucketed.py's case: grad_mag (halo 6, the magnitude
    reflected again) in bucket 64 at 87 x 113 equals Model.detect."""
    jm, tm = model_pair("grad_mag", 2, (8, 8, 1), smooth=1, n_per_oct=4)
    img = np.random.RandomState(7).randint(0, 256, (87, 113)).astype(
        np.uint8)
    got = BucketedDetector(tm, bucket=64, k=256, device="cpu").detect(img)
    np.testing.assert_array_equal(rows(got), rows(tm.detect(img)))
    assert flips(jbucket.BucketedDetector(jm, bucket=64, k=256).detect(img),
                 got) <= 0.005


@pytest.mark.parametrize("smooth", [0, 1])
def test_channel_pyramid_shrink1_matches_jax(smooth):
    """The per-level pyramid at shrink 1 (cut from the image-space
    canvas) against JAX's per-level chain: bitwise up to values below
    2**-30."""
    img = frames(1, seed=41)[0]
    opts = dict(shrink=1, n_per_oct=2, smooth=smooth, channels="grad_hist")
    want = list(jchannel_pyramid(img, opts))
    got = list(wt.channels.channel_pyramid(img, opts, device="cpu"))
    assert len(got) == len(want)
    for (tc, ts), (jc, js) in zip(got, want):
        assert ts == js and tc.shape == jc.shape
        tiny = (np.abs(tc) < 2.0 ** -30) & (np.abs(jc) < 2.0 ** -30)
        assert np.array_equal(tc[~tiny], jc[~tiny])


def test_train_shrink1_teacher_forced_matches_jax():
    """wt.train at shrink 1, 2 stages, teacher-forced (the port fits its
    own tree, appends JAX's): pools' labels, ids and scores, thetas,
    learner statistics and counters bitwise."""
    opts = dict(shrink=1, n_per_oct=2, smooth=1, channels="grad_hist")
    jm = wb.Model((8, 8, 4), opts)
    jp = wb.SamplePool(min_tp=60, min_fp=60, seed=0)
    jl = wb.Learner(alpha=0.2, max_depth=2)
    wb.train(jm, jutils.fake_data_generator(seed=3), pool=jp, learner=jl,
             length=2)
    forced = Forced()
    forced.trees = [as_port_tree(w) for w in jm.classifier]
    tm = wt.Model((8, 8, 4), opts, device="cpu")
    tp = wt.SamplePool(min_tp=60, min_fp=60, seed=0)
    tl = wt.Learner(alpha=0.2, wh=forced, max_depth=2)
    wt.train(tm, tutils.fake_data_generator(seed=3), pool=tp, learner=tl,
             length=2)
    assert len(tm) == len(jm) == len(forced.fits) == 2
    assert tm.theta == [float(np.float32(t)) for t in jm.theta]
    assert tl.history == jl.history
    for f in ("tp_label", "instance_id", "scores"):
        np.testing.assert_array_equal(tp.samples.get_field(f),
                                      jp.samples.get_field(f))
    for k in ("n_weak", "n_loc", "n_images"):
        assert tm.cost_stats()[k] == jm.cost_stats()[k], k


def test_grad_mag_registered():
    """grad_mag resolves under the JAX package's names (A14's raise is
    gone) and composes with grad_hist; its halo is 6."""
    for name in ("grad_mag", "waldboost.channels.grad_mag",
                 "waldboost.nb_channels.grad_mag"):
        cf = tch.resolve_channel_function(name)
        assert (cf.name, cf.halo, cf.poly) == (
            "waldboost_tpu.channels.grad_mag", 6, False)
    comp = tch.resolve_channel_function("grad_hist+grad_mag")
    assert (comp.n_channels, comp.halo, comp.poly) == (5, 6, False)
    assert comp.parts == ("waldboost_tpu.channels.grad_hist",
                          "waldboost_tpu.channels.grad_mag")


def test_canvas_golden_on_cpu():
    """chip_smoke.py's image-space golden phase on the CPU, on the first
    noise frame (tests/data/torch_port_canvas_golden.npz, made by
    scripts/make_torch_canvas_golden.py): the shrink-1 cascade's
    survivors, n_weak and the host, batched and bucketed detectors' kept
    boxes bitwise JAX's (its float frame within the flip bound), the
    grad_mag and composite cascades within the flip bound."""
    import chip_smoke as cs
    g = np.load(cs.CANVAS_GOLDEN)
    res = cs.canvas_golden_run(wt, CPU, g, cs.canvas_golden_frames(g), [3])
    assert res["s1"][0] > 0 and res["grad_mag"][0] > 0
    assert res["hist_mag"][0] > 0


def test_train_sharded_shrink1_teacher_forced_matches_jax():
    """The device-pool trainer at shrink 1, 2 stages, teacher-forced as
    test_torch_device_train.py does (JAX's step tree recorded, the port's
    fit checked against it and replaced): models, thetas, learner
    statistics, pools (samples up to values below 2**-30) and counters
    equal JAX's train_sharded."""
    from waldboost_tpu.parallel import trainer as jtrainer
    from waldboost_tpu_torch.parallel import trainer as ttrainer
    from test_torch_device_train import _assert_pools_equal, forced_fits

    opts = dict(shrink=1, n_per_oct=2, smooth=1, channels="grad_hist")
    trees = []
    real_make = jtrainer.make_train_step

    def recording(**kwargs):
        step = real_make(**kwargs)

        def rec(*args):
            res = step(*args)
            trees.append(tuple(np.asarray(a) for a in res.tree))
            return res
        return rec

    jm, tm = wb.Model((8, 8, 4), opts), wt.Model((8, 8, 4), opts,
                                                 device="cpu")
    jl, tl = (pkg.Learner(alpha=0.2, max_depth=2) for pkg in (wb, wt))
    jpools, tpools = {}, {}
    jtrainer.make_train_step = recording
    try:
        jtrainer.train_sharded(jm, jutils.fake_data_generator(seed=29),
                               mesh=None, learner=jl, length=2, min_tp=100,
                               min_fp=100, seed=1, pools=jpools)
    finally:
        jtrainer.make_train_step = real_make
    with forced_fits(trees) as used:
        ttrainer.train_sharded(tm, tutils.fake_data_generator(seed=29),
                               learner=tl, length=2, min_tp=100, min_fp=100,
                               seed=1, pools=tpools)
    assert len(used) == len(tm) == len(jm) == 2
    for (js, jt), (ts, tt) in zip(jm, tm):
        want = js.to_stage_dict()
        for k in want:
            np.testing.assert_array_equal(ts[k], want[k])
        assert tt == jt
    assert [r[:2] for r in tl.history] == [r[:2] for r in jl.history]
    for k in ("fp", "tp"):
        _assert_pools_equal(jpools[k], tpools[k], mined=True)
    for k in ("n_weak", "n_loc", "n_images"):
        assert tm.cost_stats()[k] == jm.cost_stats()[k], k
