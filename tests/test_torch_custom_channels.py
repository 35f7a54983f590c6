"""Channel functions a user supplies as a callable, the per-level canvas
and ``compute_pyramid``, against the JAX package on the CPU.

Two user functions, each written once in jnp and once in torch and
registered under the same name in each package: ``user_grad`` (the image
and ``|gx|`` of ``ops.image.gradients`` as two float32 channels) and
``user_id_u8`` (the frame itself, so a uint8 frame's pool wraps mod 256
and its smooth truncates).  Neither has a canvas form, so every canvas is
built level by level (JAX: ``polyphase.py::_channel_canvas_per_level``),
as is a composite with such a part.  Inputs are numpy-seeded frames, a
separate buffer for each package.

Tolerance: uint8 frames bitwise (channels, survivors, scores, counts,
slot order); float32 frames within PARITY.md's float contract (channels
within 16 ULP, the observed maximum printed; boxes flipping in at most
0.5% of the survivors).  The built-in functions' ``fn`` against JAX's:
FPGA kinds and grad_mag on uint8 bitwise, grad_hist bitwise except values
below 2**-30 (PARITY.md section 1c).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import utils as jutils
from waldboost_tpu.parallel import bucket as jbucket
from waldboost_tpu.parallel import detect as jdet

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import utils as tutils
from waldboost_tpu_torch.canvas import channel_canvas
from waldboost_tpu_torch.packing import _packed_plan_cached
from waldboost_tpu_torch.parallel.bucket import (BucketedDetector,
                                                 make_bucket_detector_boxes)
from waldboost_tpu_torch.parallel.detect import detect_batch
from waldboost_tpu_torch.parallel.mesh import gather, make_mesh

from test_torch_image import ulps
from test_torch_train import _assert_runs_equal
from test_torch_training import Forced, as_port_tree
from test_torch_twophase import assert_bitwise
from torch_port_util import make_model_pair, noise_frames, sorted_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import user_grad as user_grad_t  # noqa: E402 (torch)
from scripts import make_torch_custom_channels_golden as golden  # noqa: E402

torch.set_num_threads(4)

HW = (48, 64)
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "torch_port_custom_channels_golden.npz")


def user_grad_j(image):
    return golden.user_grad(image)


def user_id_u8_j(image):
    return image[None]


def user_id_u8_t(image):
    return image[None]


for _name, _j, _t, _c in (("user_grad", user_grad_j, user_grad_t, 2),
                          ("user_id_u8", user_id_u8_j, user_id_u8_t, 1)):
    wb.channels.register_channel_function(
        wb.channels.ChannelFunction(_name, _j, _c))
    wt.channels.register_channel_function(
        wt.channels.ChannelFunction(_name, _t, _c))


def opts(channels, smooth=1, n_per_oct=2):
    return dict(shrink=2, n_per_oct=n_per_oct, smooth=smooth,
                channels=channels)


def frames(n, dtype, seed, hw=HW):
    imgs = noise_frames(n, hw, seed)
    if dtype == np.uint8:
        return imgs
    rng = np.random.RandomState(seed + 1000)
    return (imgs + rng.rand(*imgs.shape)).astype(np.float32)


def assert_close(got, want, dtype, what):
    """Bitwise for uint8 frames; within 16 ULP for float32 frames."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if dtype == np.uint8 or got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        d = ulps(got, want)
        print(f"{what}: max {d} ULP")
        assert d <= 16, what


# -- ChannelFunction ---------------------------------------------------------

def test_channel_function_is_positional_callable_and_registers():
    cf = wt.channels.ChannelFunction("test_twice", lambda im: im[None] * 2, 1)
    assert cf.fn is not None and not cf.canvas
    assert wt.channels.register_channel_function(cf) is cf
    assert wt.channels.resolve_channel_function("test_twice") is cf
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(cf(x), x[None] * 2)
    for name in ("grad_hist", "grad_mag", "grad_hist_4_u1", "grad_mag_u1",
                 "grad_hist_4_u1+grad_mag_u1", "grad_hist+grad_mag"):
        assert wt.channels.resolve_channel_function(name).canvas, name
    mixed = wt.channels.resolve_channel_function("grad_hist+user_grad")
    assert not mixed.canvas and mixed.n_channels == 6
    assert mixed.name == wb.channels.resolve_channel_function(
        "grad_hist+user_grad").name


def test_default_channel_opts_match_jax():
    got, want = wt.default_channel_opts, wb.default_channel_opts
    assert got is wt.channels.default_channel_opts
    for key in ("shrink", "n_per_oct", "smooth"):
        assert got[key] == want[key], key
    assert got["channels"].name == want["channels"].name \
        == "waldboost_tpu.channels.grad_hist"
    assert got["channels"] is wt.channels.grad_hist
    wt.Model((12, 12, 4), wt.default_channel_opts, device="cpu")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name", ["grad_hist", "grad_mag", "grad_hist_4_u1",
                                  "grad_mag_u1", "grad_hist_4_u1+grad_mag_u1",
                                  "grad_hist+grad_mag"])
def test_builtin_fn_matches_jax(name, dtype):
    """Each built-in function's ``fn`` (and ``__call__``) on a 21 x 18
    image against JAX's ``cf.fn``."""
    img = frames(1, dtype, seed=4, hw=(21, 18))[0]
    got = wt.channels.resolve_channel_function(name)(
        torch.from_numpy(img.copy())).numpy()
    want = np.asarray(wb.channels.resolve_channel_function(name).fn(
        jnp.asarray(img.copy())))
    assert got.shape == want.shape and got.dtype == want.dtype
    tiny = (np.abs(got) < 2.0 ** -30) & (np.abs(want) < 2.0 ** -30)
    got, want = np.where(tiny, 0, got), np.where(tiny, 0, want)
    if dtype == np.uint8 and "grad_mag" != name.split("+")[-1]:
        np.testing.assert_array_equal(got, want)
    else:
        assert_close(got, want, np.float32, name)


# -- compute_pyramid and the per-level canvas --------------------------------

@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", ["user_grad", "user_id_u8",
                                      "grad_hist+user_grad"])
def test_compute_pyramid_matches_jax(channels, dtype, smooth):
    """Every level, (C, h, w) in the function's own dtype, on a frame of
    odd size: user_id_u8's uint8 pool wraps."""
    img = frames(1, dtype, seed=5, hw=(45, 61))[0]
    o = opts(channels, smooth, n_per_oct=3)
    got = wt.channels.compute_pyramid(img.copy(), o, device="cpu")
    want = wb.channels.compute_pyramid(jnp.asarray(img.copy()), o)
    assert len(got) == len(want) == 9
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb and isinstance(a, torch.Tensor)
        assert_close(a.numpy(), b, dtype, f"{channels} {a.shape}")
    # the wrap: 4 x 200 = 800 = 32 mod 256, / 4
    if channels == "user_id_u8" and dtype == np.uint8:
        lv = wt.channels.compute_pyramid(np.full((16, 16), 200, np.uint8),
                                         opts(channels, 0), device="cpu")
        assert int(lv[0][0][0, 0, 0]) == 8


@pytest.mark.parametrize("channels", ["grad_hist", "grad_hist_4_u1",
                                      "grad_mag"])
def test_compute_pyramid_canvas_cut_matches_per_level(channels):
    """A built-in function's levels cut out of its kernel (or image-space)
    canvas equal the per-level route through its ``fn`` (grad_mag within
    the 4 ULP recorded for its float32 sums, ROADMAP section C: the
    image-space canvas sums its triangle filter in float64, the per-level
    ``fn`` in float32 as JAX does), and the per-level route equals JAX's
    ``compute_pyramid`` bitwise."""
    img = frames(1, np.uint8, seed=6, hw=(45, 61))[0]
    o = opts(channels, 1, n_per_oct=3)
    cf = wt.channels.resolve_channel_function(channels)
    per_level = dataclasses.replace(cf, name="per_level_" + cf.name,
                                    aliases=(), canvas=False)
    cut = wt.channels.compute_pyramid(img, o, device="cpu")
    lev = wt.channels.compute_pyramid(img, dict(o, channels=per_level),
                                      device="cpu")
    want = wb.channels.compute_pyramid(jnp.asarray(img.copy()), o)
    for (a, sa), (b, _), (c, sc) in zip(cut, lev, want):
        assert sa == sc and a.dtype == b.dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
        if channels == "grad_mag":
            assert ulps(a.numpy(), b.numpy()) <= 4
        else:
            tiny = (a.abs() < 2.0 ** -30) & (b.abs() < 2.0 ** -30)
            assert torch.equal(torch.where(tiny, 0, a),
                               torch.where(tiny, 0, b))


def test_channel_pyramid_of_a_user_function():
    img = frames(1, np.uint8, seed=7)[0]
    o = opts("user_grad")
    got = list(wt.channels.channel_pyramid(img, o, device="cpu"))
    want = list(wb.channels.channel_pyramid(img, o))
    assert len(got) == len(want) > 0
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb and a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_per_level_canvas_matches_jax(dtype):
    """The batched canvas: each level's channels at its place, zero
    elsewhere, as JAX's ``_channel_canvas_batch`` builds it."""
    from waldboost_tpu.polyphase import _channel_canvas_batch
    imgs = frames(2, dtype, seed=8)
    cf = wt.channels.resolve_channel_function("user_grad")
    packed = _packed_plan_cached(*HW, 2, 2, (8, 8), halo=cf.halo)
    step = channel_canvas(packed, HW, 1, cf, torch.device("cpu"))
    assert step.per_level
    got = step(torch.from_numpy(imgs.copy())).numpy()
    jcf = wb.channels.resolve_channel_function("user_grad")
    jpacked = wb.model._packed_plan_cached(*HW, 2, 2, (8, 8), halo=jcf.halo)
    want = _channel_canvas_batch(jnp.asarray(imgs.copy()), 2, 2, 1, jcf,
                                 jpacked)
    assert_close(got, want, dtype, "per-level canvas")
    inside = packed.level_interior_mask()
    assert (got[:, :, ~inside] == 0).all()


# -- serving -----------------------------------------------------------------

_PAIRS = {}
#: the cascade seed of each function: a few dozen survivors a 48 x 64
#: noise frame, so the extraction (k=512, under the 4800-origin grid) is
#: complete
SEEDS = {"user_grad": 3, "grad_hist+user_grad": 3, "user_id_u8": 5}


def pair(channels):
    """A JAX model over ``channels`` with 8 random stages and its port."""
    if channels not in _PAIRS:
        n = wt.channels.resolve_channel_function(channels).n_channels
        _PAIRS[channels] = make_model_pair(n_stages=8, shape=(8, 8, n),
                                           seed=SEEDS[channels],
                                           channels=channels, thr_max=200.0)
    return _PAIRS[channels]


def flip_share(a, b):
    """Share of boxes in one row set and not the other."""
    sa, sb = {tuple(r) for r in a}, {tuple(r) for r in b}
    return len(sa ^ sb) / max(len(sa | sb), 1)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", ["user_grad", "user_id_u8",
                                      "grad_hist+user_grad"])
def test_model_detect_matches_jax(channels, dtype):
    """``Model.detect`` and ``Model.channels``: uint8 bitwise; float32
    boxes within 0.5% flips (the scores of boxes both keep bitwise)."""
    jm, tm = pair(channels)
    for img in frames(2, dtype, seed=9):
        a, b = tm.detect(img.copy()), jm.detect(img.copy())
        ra = sorted_rows(a.get(), a.get_field("scores"))
        rb = sorted_rows(b.get(), b.get_field("scores"))
        assert len(rb) > 0
        if dtype == np.uint8:
            np.testing.assert_array_equal(ra, rb)
        else:
            assert flip_share(ra, rb) <= 0.005
        assert tm.cost_stats()["n_weak"] > 0
    img = frames(1, dtype, seed=10)[0]
    for (a, sa), (b, sb) in zip(tm.channels(img), jm.channels(img)):
        assert sa == sb
        assert_close(a, b, dtype, f"channels {a.shape}")


@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("channels", ["user_grad", "grad_hist+user_grad"])
def test_batched_detector_matches_jax(channels, two_phase):
    """``make_batched_detector_boxes``, dense and two-phase (prefix 4,
    capacity 1024: under the grid's size, where XLA's tie order is the
    lowest index first): all five outputs bitwise JAX's, in its slot
    order."""
    jm, tm = pair(channels)
    imgs = frames(3, np.uint8, seed=11)
    kw = dict(k=512, nms_iou=0.5, two_phase=two_phase)
    if two_phase:
        kw.update(prefix=4, capacity=1024)
    fj, _ = jdet.make_batched_detector_boxes(jm, HW, **kw)
    want = [np.asarray(a) for a in fj(jnp.asarray(imgs.copy()))]
    ft, _ = wt.make_batched_detector_boxes(tm, HW, device="cpu", **kw)
    got = [a.numpy() for a in ft(torch.from_numpy(imgs.copy()))]
    assert_bitwise(got, want)
    assert (got[3] > 0).all()


def test_detect_batch_multi_and_mesh_match():
    """``detect_batch`` against JAX's; ``make_multi_detector_boxes``
    (the user model twice, one scaled) and a mesh of two CPU devices
    against the single-model port."""
    jm, tm = pair("user_grad")
    imgs = frames(2, np.uint8, seed=12)
    got = detect_batch(tm, imgs.copy(), k=1024)
    want = jdet.detect_batch(jm, jnp.asarray(imgs.copy()), k=1024)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(
            sorted_rows(a.get(), a.get_field("scores")),
            sorted_rows(b.get(), b.get_field("scores")))
    x = torch.from_numpy(imgs.copy())
    single = wt.make_batched_detector_boxes(tm, HW, k=512, device="cpu")[0](x)
    multi, _ = wt.make_multi_detector_boxes([tm, tm], HW, k=512,
                                            response_scale=[1, 0.5],
                                            device="cpu")
    rects, scores, valid, label = multi(x)[:4]
    first = label == 0                       # the first model's k slots
    assert torch.equal(rects[first].view(2, 512, 4), single[0])
    assert torch.equal(scores[first].view(2, 512), single[1])
    assert torch.equal(valid[first].view(2, 512), single[2])
    assert torch.equal(scores[~first].view(2, 512),
                       torch.where(single[2], single[1] * 0.5, single[1]))
    mesh = make_mesh(devices=["cpu"] * 2)
    meshed, _ = wt.make_batched_detector_boxes(tm, HW, k=512, mesh=mesh)
    outs = [gather(o, mesh) for o in meshed(x)]
    for a, b in zip(outs, single):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_bucket_matches_jax(dtype):
    """``BucketedDetector`` takes JAX's route for a function without a
    canvas form (no bucket program: ``Model.detect`` at the true size,
    then NMS): JAX's boxes at two sizes of one bucket."""
    jm, tm = pair("user_grad")
    imgs = [frames(1, dtype, seed=13, hw=(48, 64))[0],
            frames(1, dtype, seed=14, hw=(40, 56))[0]]
    assert make_bucket_detector_boxes(tm, (64, 64), device="cpu") is None
    assert jbucket.make_bucket_detector_boxes(jm, (64, 64)) is None
    det = BucketedDetector(tm, bucket=64, k=512, nms_iou=0.5,
                           track_cost=True, device="cpu")
    jdet_ = jbucket.BucketedDetector(jm, bucket=64, k=512, nms_iou=0.5)
    got = det.detect_many([im.copy() for im in imgs])
    want = jdet_.detect_many([im.copy() for im in imgs])
    for a, b in zip(got, want):
        ra = sorted_rows(a.get(), a.get_field("scores"))
        rb = sorted_rows(b.get(), b.get_field("scores"))
        if dtype == np.uint8:
            np.testing.assert_array_equal(ra, rb)
        else:
            assert flip_share(ra, rb) <= 0.005
    assert tm.cost_stats()["n_images"] >= 2


def test_train_teacher_forced_matches_jax():
    """A 3-stage ``wt.train`` over ``user_grad``, teacher-forced: trees,
    thetas, learner statistics, pools and counters as JAX's."""
    shape, o = (8, 8, 2), opts("user_grad")
    jm = wb.Model(shape, o)
    jp = wb.SamplePool(min_tp=60, min_fp=60, seed=0)
    jl = wb.Learner(alpha=0.2, max_depth=2)
    wb.train(jm, jutils.fake_data_generator(seed=3), pool=jp, learner=jl,
             length=3)
    forced = Forced()
    forced.trees = [as_port_tree(w) for w in jm.classifier]
    tm = wt.Model(shape, o, device="cpu")
    tp = wt.SamplePool(min_tp=60, min_fp=60, seed=0)
    tl = wt.Learner(alpha=0.2, wh=forced, max_depth=2)
    wt.train(tm, tutils.fake_data_generator(seed=3), pool=tp, learner=tl,
             length=3)
    _assert_runs_equal(jm, jl, jp, tm, tl, tp, forced.fits)


def test_custom_channels_golden_on_cpu(tmp_path):
    """chip_smoke.py phase 10's golden on the CPU, two of its eight VGA
    frames: the JAX-trained ``user_grad`` model loads and serves JAX's
    boxes, scores and counts bitwise."""
    g = np.load(GOLDEN)
    path = tmp_path / "user_grad.pb"
    path.write_bytes(g["model"].tobytes())
    model = wt.load(str(path), device="cpu")
    assert model.channel_opts["channels"].name == "user_grad"
    imgs = golden.golden_frames(tutils.scene_generator)
    assert golden.frames_digest(imgs) == str(g["frames_sha256"])
    fn, _ = wt.make_batched_detector_boxes(model, golden.VGA, k=golden.K,
                                           device="cpu")
    rects, scores, valid, count, _ = (a.numpy() for a in fn(
        torch.from_numpy(imgs[:2])))
    np.testing.assert_array_equal(count, g["count"][:2])
    for i in range(2):
        v = valid[i]
        np.testing.assert_array_equal(v, g["valid"][i])
        np.testing.assert_array_equal(rects[i][v], g["rects"][i][v])
        np.testing.assert_array_equal(scores[i][v], g["scores"][i][v])
