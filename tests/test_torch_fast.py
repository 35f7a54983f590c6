"""PyTorch port, fast serving mode on the CPU: every module of the slice
held against the JAX package's ``WB_SERVING_MODE=fast`` path on the same
seeded inputs, with tolerance 0 (bfloat16 canvases compared by their
bits).

The JAX fast path is the fused Pallas channel kernel with ``fast=True``
(B2f) and the static cascade kernel with ``fast=True`` (B3f).  Off the TPU
the JAX package builds its canvas with XLA unless the channel backend is
set to ``"pallas"`` (then both kernels run in interpret mode), so the
oracle here sets it for the build and the call and restores it after.

Covered: the f32 octave chain, the float planes (f32 and bf16), B2f's
plain version for bf16-integer, f32 and bf16 planes, B3f's plain version,
the whole slice (uint8 and float frames, ``with_n_weak`` both ways, NMS
0.5 and none), ``make_multi_detector_boxes`` and
``make_batched_detector`` in fast mode, an FPGA model (no fast variant:
fast equals exact), the port's own fast-against-exact deviation bound,
and a frame of the committed VGA fast golden."""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_model
from waldboost_tpu import model as JM
from waldboost_tpu.channels import _compute_octaves_f32, _normalize_opts
from waldboost_tpu.ops.cascade_static import (cascade_masked_grid_static,
                                              static_cascade_from_model)
from waldboost_tpu.ops.channels_pallas import grad_hist_poly_pallas
from waldboost_tpu.parallel import detect as jdet
from waldboost_tpu.polyphase import _poly_planes

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import packing, polyphase
from waldboost_tpu_torch.ops import cascade_static as tcs
from waldboost_tpu_torch.ops import channels as tcc
from waldboost_tpu_torch.ops import planes as tpl

from torch_port_util import make_model_pair, noise_frames, sorted_rows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (96, 128)
#: frame sizes of the module tests: a plain one and one with odd sides
SIZES = [((48, 64), 2), ((57, 83), 2)]


@contextlib.contextmanager
def jax_fast(fast_float="f32"):
    """The JAX package in fast serving mode (``WB_FAST_FLOAT=bf16`` for
    bf16 float planes) with its Pallas channel kernel."""
    keys = ("WB_SERVING_MODE", "WB_FAST_FLOAT")
    prev = {k: os.environ.get(k) for k in keys}
    backend = JM._CHANNEL_BACKEND
    os.environ["WB_SERVING_MODE"] = "fast"
    os.environ.pop("WB_FAST_FLOAT", None)
    if fast_float == "bf16":
        os.environ["WB_FAST_FLOAT"] = "bf16"
    JM.set_channel_backend("pallas")
    try:
        yield
    finally:
        JM.set_channel_backend(backend)
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def float_frames(n, hw, seed):
    """Seeded float32 frames: uint8 noise plus uniform [0, 1) noise."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (n,) + tuple(hw))
    return (base + rng.rand(n, *hw)).astype(np.float32)


def bits(a) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 torch tensor or jax array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def fast_model_pair():
    """tests/test_fast_mode.py's model (16 stages, 8x8x4, npo 2, smooth 1)
    and its port."""
    jm = _flagship_model(seed=0, n_stages=16, shape=(8, 8, 4),
                         channel_opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                           channels="grad_hist"),
                         image_hw=HW)
    tm = wt.model_from_stages(jm.shape, jm.channel_opts,
                              [w.to_stage_dict() for w in jm.classifier],
                              jm.theta, device="cpu")
    return jm, tm


def _plans(hw, npo):
    _, _, _, cf = _normalize_opts(dict(shrink=2, n_per_oct=npo, smooth=1,
                                       channels="grad_hist"))
    jp = JM._packed_plan_cached(hw[0], hw[1], 2, npo, (8, 8), halo=cf.halo)
    tp = packing._packed_plan_cached(hw[0], hw[1], 2, npo, (8, 8), halo=1)
    return cf, jp, tp


# -- modules ------------------------------------------------------------------

@pytest.mark.parametrize("hw,npo", SIZES)
def test_octaves_f32_match_jax(hw, npo):
    imgs = float_frames(2, hw, seed=1)
    _, _, tp = _plans(hw, npo)
    n_oct = len(polyphase.float_plane_tables(tp, tp.halo, hw).oct_hw)
    got = tch.level_octaves(torch.from_numpy(imgs), n_oct)
    assert n_oct >= 2
    for b in range(2):
        want = _compute_octaves_f32(jnp.asarray(imgs[b]), n_oct)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("fast_float", ["f32", "bf16"])
@pytest.mark.parametrize("hw,npo", SIZES)
def test_planes_float_fast_match_jax(hw, npo, fast_float):
    imgs = float_frames(2, hw, seed=2)
    cf, jp, tp = _plans(hw, npo)
    tables = polyphase.float_plane_tables(tp, tp.halo, hw)
    ops = tpl.FloatPlaneOperands.build(tables, "cpu")
    octs = tpl.octave_buffer(tch.level_octaves(torch.from_numpy(imgs),
                                               len(tables.oct_hw)))
    bf16 = fast_float == "bf16"
    got = tpl.planes_float_fast(octs, ops,
                                torch.bfloat16 if bf16 else torch.float32)
    for b in range(2):
        want = _poly_planes(jnp.asarray(imgs[b]), cf, jp, fast=True,
                            fast_bf16=bf16)
        assert want.shape == got.shape[1:]
        if bf16:
            np.testing.assert_array_equal(bits(got[b]), bits(want))
        else:
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("kind", ["uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("hw,npo", SIZES)
def test_grad_hist_fast_matches_jax(hw, npo, kind, smooth):
    """B2f's plain version against grad_hist_poly_pallas(fast=True) on
    the same planes: uint8 (bf16 integers on the JAX side), f32, bf16."""
    _, _, tp = _plans(hw, npo)
    rng = np.random.RandomState(hw[0] + 10 * smooth)
    shape = (2, 2, 2, tp.canvas_h, tp.canvas_w)
    if kind == "uint8":
        planes = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
        planes_j = jnp.asarray(planes.numpy()).astype(jnp.bfloat16)
    else:
        vals = (rng.rand(*shape) * 256).astype(np.float32)
        planes = torch.from_numpy(vals)
        planes_j = jnp.asarray(vals)
        if kind == "bfloat16":
            planes = planes.to(torch.bfloat16)
            planes_j = planes_j.astype(jnp.bfloat16)
    mask = tp.smooth_interior_mask()
    got = tcc.grad_hist_fast(
        planes, torch.from_numpy(mask.astype(np.uint8)) if smooth else None,
        smooth)
    want = grad_hist_poly_pallas(planes_j,
                                 jnp.asarray(mask) if smooth else None,
                                 smooth, interpret=True, fast=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("hw,npo", SIZES)
def test_cascade_fast_matches_jax(hw, npo):
    """B3f's plain version over a bf16 canvas against
    cascade_masked_grid_static(fast=True, with_n_weak=False): the same
    finite set, scores and counts; and equal to B3 over the f32 copy."""
    jm, tm = make_model_pair(n_stages=20, shape=(8, 8, 4), seed=4,
                             n_per_oct=npo)
    _, _, tp = _plans(hw, npo)
    rng = np.random.RandomState(7)
    vals = (rng.rand(2, 2, 2, tp.canvas_h, tp.canvas_w) * 256)
    mask = torch.from_numpy(tp.smooth_interior_mask().astype(np.uint8))
    canvas = tcc.grad_hist_fast(torch.from_numpy(vals.astype(np.float32)),
                                mask, 1)
    valid = tp.valid_mask((8, 8))
    ops = tcs.CascadeOperands.build(tcs.static_cascade_from_model(tm),
                                    (8, 8), 4, "cpu")
    vt = torch.from_numpy(valid.astype(np.uint8))
    masked, n_weak, count = tcs.cascade_masked(canvas, vt, ops)
    cj = jnp.asarray(canvas.float().numpy()).astype(jnp.bfloat16)
    mj, _, cnt_j = cascade_masked_grid_static(
        cj, static_cascade_from_model(jm), jnp.asarray(valid), (8, 8),
        interpret=True, with_n_weak=False, fast=True)
    gu, gv = valid.shape
    mj = np.asarray(mj)[:, :gu, :gv]
    alive = np.isfinite(masked.numpy())
    np.testing.assert_array_equal(alive, np.isfinite(mj))
    np.testing.assert_array_equal(masked.numpy()[alive], mj[alive])
    np.testing.assert_array_equal(count.numpy(), np.asarray(cnt_j))
    assert 0 < int(count.sum()) < 2 * valid.sum()
    for a, b in zip((masked, n_weak, count),
                    tcs.cascade_masked(canvas.float(), vt, ops)):
        assert torch.equal(a, b)


# -- the slice ----------------------------------------------------------------

def _compare_boxes(got, want):
    rt, st, vt, ct, nwt = got
    rj, sj, vj, cj, nwj = want
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nwt, nwj)
    for b in range(len(ct)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))


@pytest.mark.parametrize("model", ["test_fast_mode", "random"])
@pytest.mark.parametrize("frames,fast_float,with_n_weak,nms_iou", [
    ("uint8", "f32", False, 0.5),
    ("uint8", "f32", False, None),
    ("uint8", "f32", True, 0.5),
    ("uint8", "f32", True, None),
    ("float32", "f32", False, 0.5),
    ("float32", "f32", True, None),
    ("float32", "bf16", False, None),
    ("float32", "bf16", True, 0.5),
])
def test_fast_slice_matches_jax(model, frames, fast_float, with_n_weak,
                                nms_iou):
    """make_batched_detector_boxes(fast=True) against JAX's build under
    WB_SERVING_MODE=fast: counts, n_weak, kept boxes and scores."""
    if model == "random":
        jm, tm = make_model_pair(n_stages=24, seed=4)
    else:
        jm, tm = fast_model_pair()
    images = noise_frames(3, HW, seed=3) if frames == "uint8" \
        else float_frames(3, HW, seed=3)
    with jax_fast(fast_float):
        fj, _ = jdet.make_batched_detector_boxes(
            jm, HW, k=1024, nms_iou=nms_iou, with_n_weak=with_n_weak)
        want = [np.asarray(a) for a in fj(jnp.asarray(images))]
    ft, _ = wt.make_batched_detector_boxes(
        tm, HW, k=1024, nms_iou=nms_iou, with_n_weak=with_n_weak,
        device="cpu", fast=True, fast_float=fast_float)
    got = [a.numpy() for a in ft(torch.from_numpy(images))]
    _compare_boxes(got, want)
    assert (got[4] > 0).all() == with_n_weak
    if model == "random":
        assert (got[3] > 0).all()


@pytest.mark.parametrize("frames", ["uint8", "float32"])
def test_fast_multi_and_batched_detector_match_jax(frames):
    """make_multi_detector_boxes(fast=True) over two models, and
    make_batched_detector(fast=True) with and without n_stages_cap."""
    pairs = [make_model_pair(n_stages=8, shape=(8, 8, 4), seed=20),
             make_model_pair(n_stages=10, shape=(10, 12, 4), seed=21)]
    jms, tms = [p[0] for p in pairs], [p[1] for p in pairs]
    images = noise_frames(2, HW, seed=24) if frames == "uint8" \
        else float_frames(2, HW, seed=24)
    with jax_fast():
        fj, _ = jdet.make_multi_detector_boxes(
            jms, HW, k=2048, nms_iou=0.4, response_scale=[1.0, 0.5],
            with_n_weak=True)
        want = [np.asarray(a) for a in fj(jnp.asarray(images))]
        caps = {}
        for cap in (None, 6):
            fb, _ = jdet.make_batched_detector(jms[0], HW, n_stages_cap=cap)
            caps[cap] = [np.asarray(a) for a in fb(jnp.asarray(images))]
    ft, _ = wt.make_multi_detector_boxes(
        tms, HW, k=2048, nms_iou=0.4, response_scale=[1.0, 0.5],
        device="cpu", fast=True)
    rects, scores, valid, label, count, n_weak = (
        a.numpy() for a in ft(torch.from_numpy(images)))
    jr, js, jv, jl, jc, jnw = want
    np.testing.assert_array_equal(count, jc)
    np.testing.assert_array_equal(n_weak, jnw)
    assert (count > 0).all()
    for b in range(2):
        for kix in range(2):
            sel, jsel = valid[b] & (label[b] == kix), jv[b] & (jl[b] == kix)
            np.testing.assert_array_equal(
                sorted_rows(rects[b][sel], scores[b][sel]),
                sorted_rows(jr[b][jsel], js[b][jsel]))
    for cap, ref in caps.items():
        fb, _ = wt.make_batched_detector(tms[0], HW, n_stages_cap=cap,
                                         device="cpu", fast=True)
        for a, r in zip(fb(torch.from_numpy(images)), ref):
            np.testing.assert_array_equal(a.numpy(), r)


def test_fast_fpga_model_equals_exact():
    """FPGA channels have no fast variant: the port's fast mode gives its
    exact results, and JAX's fast mode the same."""
    jm, tm = make_model_pair(n_stages=24, shape=(8, 8, 5), seed=4,
                             n_per_oct=2, smooth=0, thr_max=60.0,
                             channels="grad_hist_4_u1+grad_mag_u1")
    images = noise_frames(2, HW, seed=23)
    outs = []
    for fast in (True, False):
        ft, _ = wt.make_batched_detector_boxes(tm, HW, k=2048, device="cpu",
                                               fast=fast)
        outs.append([a.numpy() for a in ft(torch.from_numpy(images))])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    with jax_fast():
        fj, _ = jdet.make_batched_detector_boxes(jm, HW, k=2048)
        want = [np.asarray(a) for a in fj(jnp.asarray(images))]
    _compare_boxes(outs[0], want)
    assert (outs[0][3] > 0).all()


def test_fast_deviation_from_exact_bounded():
    """The port's fast mode against its exact mode: at most 25% box flips
    (tests/test_fast_mode.py's bound for JAX's)."""
    _, tm = make_model_pair(n_stages=24, seed=4)
    images = torch.from_numpy(noise_frames(4, HW, seed=0))
    outs = []
    for fast in (False, True):
        fn, _ = wt.make_batched_detector_boxes(tm, HW, k=1024, device="cpu",
                                               with_n_weak=False, fast=fast)
        outs.append([a.numpy() for a in fn(images)])
    total = flips = 0
    for b in range(4):
        sets = [{tuple(np.round(x, 2)) for x in o[0][b][o[2][b]]}
                for o in outs]
        total += max(len(sets[0]), 1)
        flips += len(sets[0] ^ sets[1])
    assert total > 4
    assert flips <= 0.25 * total, (flips, total)


def test_fast_options_checked():
    _, tm = make_model_pair(n_stages=2)
    with pytest.raises(ValueError, match="fast_float"):
        wt.make_batched_detector_boxes(tm, (48, 64), device="cpu", fast=True,
                                       fast_float="f16")
    fn, _ = wt.make_batched_detector_boxes(tm, (48, 64), device="cpu",
                                           fast=True)
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 48, 64), dtype=torch.float64))
    # an FPGA model has no fast variant: its float frames take the exact
    # float path, as without fast
    fpga = make_model_pair(n_stages=2, shape=(8, 8, 5),
                           channels="grad_hist_4_u1+grad_mag_u1")[1]
    fn, _ = wt.make_batched_detector_boxes(fpga, (48, 64), device="cpu",
                                           fast=True)
    exact, _ = wt.make_batched_detector_boxes(fpga, (48, 64), device="cpu")
    frames = torch.from_numpy(float_frames(1, (48, 64), seed=3))
    for a, b in zip(fn(frames), exact(frames)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fast_golden_one_frame():
    """Frame 1 of tests/data/torch_port_fast_golden.npz (JAX's fast mode
    on the VGA scene frames, flagship_synth_64, k=1024, NMS 0.5,
    scripts/make_torch_fast_golden.py) as a float32 frame with bf16
    planes: count, kept boxes and scores bitwise."""
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "torch_port_fast_golden.npz"))
    scenes = np.load(os.path.join(ROOT, "tests", "data",
                                  "torch_port_vga_golden.npz"))["frames"]
    frames = scenes + np.random.RandomState(int(g["seed"])).rand(
        *scenes.shape).astype(np.float32)
    model = wt.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"),
                    device="cpu")
    fn, _ = wt.make_batched_detector_boxes(
        model, frames.shape[1:], k=int(g["k"]), nms_iou=float(g["nms_iou"]),
        with_n_weak=False, device="cpu", fast=True, fast_float="bf16")
    rects, scores, valid, count, _ = (
        a.numpy() for a in fn(torch.from_numpy(frames[1:2])))
    key = "float_bf16"
    assert count[0] == g[key + "_counts"][1]
    rows = np.split(g[key + "_kept"], np.cumsum(g[key + "_kept_counts"])[:-1])
    assert len(rows[1]) > 0
    np.testing.assert_array_equal(
        sorted_rows(rects[0][valid[0]], scores[0][valid[0]]),
        sorted_rows(rows[1][:, :4], rows[1][:, 4]))
