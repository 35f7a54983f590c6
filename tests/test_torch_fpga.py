"""PyTorch port, the FPGA integer channel family (kernel B5's plain
version on the CPU) against the JAX package, tolerance 0 (every value is
an integer): the registry and model files, the packed plan and masks, the
B5 canvas against ``fpga_poly_pallas(interpret=True)`` and the XLA chain,
the canvas step against ``_channel_canvas_batch``, and the whole serving
slice against JAX's ``make_batched_detector_boxes``.  Marked slow: the
config-5 golden of ``scripts/make_torch_fpga_golden.py`` on one 4K frame.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import boxes as jbx
from waldboost_tpu import model as M
from waldboost_tpu.channels import \
    resolve_channel_function as jax_resolve
from waldboost_tpu.fpga.channels import _fpga_kernel_masks
from waldboost_tpu.ops.channels_pallas import fpga_poly_pallas
from waldboost_tpu.parallel.detect import \
    make_batched_detector_boxes as jax_detector

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import packing
from waldboost_tpu_torch.canvas import channel_canvas
from waldboost_tpu_torch.fpga.channels import fpga_kernel_masks
from waldboost_tpu_torch.ops import fpga as tfp

from torch_port_util import (make_model_pair, noise_frames, port_planes,
                             sorted_rows)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ["grad_hist_4_u1", "grad_mag_u1", "grad_hist_4_u1+grad_mag_u1",
         "grad_mag_u1+grad_hist_4_u1"]
FPGA_MODELS = ["fpga_4k_synth_64", "fpga_4k_smooth_synth_64"]
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_fpga_golden.npz")


def _plans(hw, cf_name, npo=4, window=(12, 12)):
    """(port plan, JAX plan, JAX channel function) of an FPGA kind."""
    cf = jax_resolve(cf_name)
    return (packing._packed_plan_cached(hw[0], hw[1], 2, npo, window,
                                        halo=cf.halo),
            M._packed_plan_cached(hw[0], hw[1], 2, npo, window,
                                  halo=cf.halo), cf)


# -- (d) registry and model files ------------------------------------------

@pytest.mark.parametrize("name", [
    "grad_hist_4_u1", "waldboost_tpu.fpga.channels.grad_hist_4_u1",
    "waldboost.fpga.channels.grad_hist_4_u1",
    "waldboost.fpga.nb_channels.grad_hist_4_u1",
    "grad_mag_u1", "waldboost_tpu.fpga.channels.grad_mag_u1",
    "waldboost.fpga.channels.grad_mag_u1",
    "waldboost.fpga.nb_channels.grad_mag_u1",
    "grad_hist_4_u1+grad_mag_u1", "grad_mag_u1+grad_hist_4_u1",
    "waldboost.fpga.nb_channels.grad_hist_4_u1+grad_mag_u1",
    "waldboost_tpu.fpga.channels.grad_hist_4_u1"
    "+waldboost_tpu.fpga.channels.grad_mag_u1",
    "grad_mag_u1+grad_mag_u1+grad_hist_4_u1",
])
def test_registry_matches_jax(name):
    got, want = tch.resolve_channel_function(name), jax_resolve(name)
    assert (got.name, got.n_channels, got.halo, got.boundary,
            got.fused_kind) == (want.name, want.n_channels, want.halo,
                                want.boundary, want.fused_kind)
    assert tch.resolve_channel_function(name) is got
    assert tch.resolve_channel_function(got.name) is got
    if "+" in name:
        # the first spelling resolved becomes the composite's alias
        assert len(got.aliases) == 1
        assert tch.resolve_channel_function(got.aliases[0]) is got
    else:
        assert set(got.aliases) == set(want.aliases)


def test_composite_alias_is_first_spelling():
    name = "grad_mag_u1+waldboost.fpga.channels.grad_mag_u1"
    got = tch.resolve_channel_function(name)
    assert got.aliases == (name,) and got.n_channels == 2
    assert got.name == "+".join([tch.resolve_channel_function(
        "grad_mag_u1").name] * 2)


def test_registry_refuses_what_jax_cannot_serve():
    with pytest.raises(ValueError):
        tch.resolve_channel_function("grad_hist+grad_hist_4_u1")
    with pytest.raises(NotImplementedError, match="A14"):
        tch.resolve_channel_function("grad_hist+grad_mag")
    with pytest.raises(KeyError):
        tch.resolve_channel_function("no_such_channels")


def test_model_file_roundtrip_both_packages(tmp_path):
    jm, tm = make_model_pair(n_stages=3, shape=(12, 12, 5), seed=4,
                             channels="grad_hist_4_u1+grad_mag_u1",
                             thr_max=40.0)
    jpath, tpath = str(tmp_path / "j.pb"), str(tmp_path / "t.pb")
    jm.save(jpath)
    tm.save(tpath)
    for jmod, tmod in ((wb.load(tpath), tm), (jm, wt.load(jpath,
                                                          device="cpu"))):
        assert tmod.channel_opts["channels"].name == \
            jmod.channel_opts["channels"].name
        assert tmod.channel_opts["channels"].n_channels == 5
        np.testing.assert_array_equal(np.asarray(tmod.theta, np.float32),
                                      np.asarray(jmod.theta, np.float32))
    with open(jpath, "rb") as f1, open(tpath, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("name,smooth", [(n, s) for n, s in
                                         zip(FPGA_MODELS, (0, 1))])
def test_committed_fpga_models_load(name, smooth):
    path = os.path.join(ROOT, "models", name + ".pb")
    jm, tm = wb.load(path), wt.load(path, device="cpu")
    assert tm.shape == jm.shape == (12, 12, 5) and len(tm) == len(jm) == 64
    opts = tm.channel_opts
    assert (opts["shrink"], opts["n_per_oct"], opts["smooth"]) == (2, 4,
                                                                   smooth)
    assert opts["channels"].name == jm.channel_opts["channels"].name
    assert opts["channels"].fused_kind == "grad_hist_4_u1+grad_mag_u1"
    for stage, weak in zip(tm.stages, jm.classifier):
        ref = weak.to_stage_dict()
        for key in ("feature", "threshold", "left", "right", "prediction"):
            np.testing.assert_array_equal(stage[key], ref[key])


# -- plan and masks --------------------------------------------------------

def test_config5_plan_matches_jax():
    """The halo-0 plan of 4K frames, field for field: 26 levels on a
    3960x2048 canvas."""
    tp, jp, _ = _plans((2160, 3840), "grad_hist_4_u1+grad_mag_u1")
    assert (len(tp.levels), tp.canvas_h, tp.canvas_w, tp.halo) == \
        (26, 3960, 2048, 0)
    assert (tp.canvas_h, tp.canvas_w, tp.shrink, tp.halo, tp.window,
            tp.bands) == (jp.canvas_h, jp.canvas_w, jp.shrink, jp.halo,
                          jp.window, jp.bands)
    assert [(pl.plan_index, pl.y, pl.x, pl.band, pl.col, vars(pl.level))
            for pl in tp.levels] == \
        [(pl.plan_index, pl.y, pl.x, pl.band, pl.col, vars(pl.level))
         for pl in jp.levels]
    assert int(tp.valid_mask((12, 12)).sum()) == 6853210


@pytest.mark.parametrize("hw", [(96, 128), (240, 320)])
def test_masks_match_jax(hw):
    tp, jp, _ = _plans(hw, "grad_hist_4_u1")
    np.testing.assert_array_equal(tp.stencil_border_mask(),
                                  jp.stencil_border_mask())
    ring, interior = fpga_kernel_masks(tp, 1)
    ring_j, interior_j = _fpga_kernel_masks(jp)
    assert ring.dtype == interior.dtype == np.uint8
    np.testing.assert_array_equal(ring, ring_j)
    np.testing.assert_array_equal(interior, interior_j)
    assert fpga_kernel_masks(tp, 0)[1] is None


# -- (a) kernel B5's plain version -----------------------------------------

@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", [(96, 128), (240, 320)])
def test_b5_plain_matches_jax(hw, kind, smooth):
    """Against fpga_poly_pallas (interpret mode) and the XLA polyphase
    chain on the same planes of a real packed plan (gaps, shelf bands,
    level rings), bitwise."""
    tp, jp, cf = _plans(hw, kind)
    imgs = noise_frames(2, hw, seed=21)
    planes = port_planes(imgs, tp)
    ring, interior = fpga_kernel_masks(tp, smooth)
    got = tfp.fpga_channels(
        planes, torch.from_numpy(ring),
        torch.from_numpy(interior) if smooth else None, cf.fused_kind,
        smooth).numpy()
    assert got.shape == (2, cf.n_channels, tp.canvas_h, tp.canvas_w)
    assert got.max() > 0 and (got == np.floor(got)).all()

    planes_j = jnp.asarray(planes.numpy()).astype(jnp.bfloat16)
    ring_j, interior_j = _fpga_kernel_masks(jp)
    kern = np.asarray(fpga_poly_pallas(
        planes_j, jnp.asarray(ring_j), kind=cf.fused_kind, smooth=smooth,
        interior_mask=jnp.asarray(interior_j) if smooth else None,
        interpret=True))
    np.testing.assert_array_equal(got, kern)
    cf_xla = dataclasses.replace(cf, poly_kernel=None)
    xla = np.asarray(M._poly_channels(planes_j, smooth, cf_xla, jp))
    np.testing.assert_array_equal(got, xla)


def test_b5_rejects_bad_inputs():
    planes = torch.zeros((1, 2, 2, 16, 16), dtype=torch.uint8)
    ring = torch.ones((2, 2, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tfp.fpga_channels(planes.float(), ring, None, "grad_mag_u1", 0)
    with pytest.raises(ValueError):
        tfp.fpga_channels(planes, ring[:, :, :15], None, "grad_mag_u1", 0)
    with pytest.raises(ValueError):
        tfp.fpga_channels(planes, ring, None, "grad_mag_u1", 1)
    with pytest.raises(ValueError):
        tfp.fpga_channels(planes, ring, None, "grad_hist", 0)
    with pytest.raises(ValueError):
        tfp.fpga_channels(planes, ring, None, "+".join(["grad_hist_4_u1"] * 5),
                          0)


# -- (b) the canvas step ---------------------------------------------------

@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("kind", KINDS[2:])
def test_canvas_step_matches_jax(kind, smooth):
    """octaves -> planes (B1, halo 0) -> B5 against JAX's
    _channel_canvas_batch on the same frames."""
    hw = (240, 320)
    tp, jp, cf = _plans(hw, kind)
    imgs = noise_frames(3, hw, seed=22)
    step = channel_canvas(tp, hw, smooth, tch.resolve_channel_function(kind),
                          torch.device("cpu"))
    assert step.plane_ops.host.meta[:, 5].min() >= 0  # halo 0: no reflect
    got = step(torch.from_numpy(imgs)).numpy()
    want = np.asarray(M._channel_canvas_batch(jnp.asarray(imgs), 2, 4,
                                              smooth, cf, jp))
    np.testing.assert_array_equal(got, want)


# -- (c) the whole slice ---------------------------------------------------

def host_nms_rows(rects, scores, iou):
    """Sorted rows of the JAX package's host greedy NMS
    (``boxes.non_max_suppression``) over one image's candidates, given in
    the order that breaks score ties."""
    bx = jbx.Boxes(np.asarray(rects, np.float32))
    bx.set_field("scores", np.asarray(scores, np.float32))
    kept = jbx.non_max_suppression(bx, iou_threshold=iou)
    return sorted_rows(kept.get(), kept.get_field("scores"))


@pytest.mark.parametrize("smooth", [0, 1])
def test_fpga_slice_matches_jax(smooth):
    """Counts, n_weak and every survivor's box and score equal JAX's
    make_batched_detector_boxes; the boxes kept by NMS 0.5 equal the JAX
    package's host NMS over those survivors.  (JAX's nms_device on XLA:CPU
    keeps one box more on frame 1 here, at an IoU of exactly 1/2 in real
    arithmetic: its fused f32 union rounds to the other side of the
    threshold; ROADMAP §C.)"""
    hw = (240, 320)
    jm, tm = make_model_pair(n_stages=8, shape=(12, 12, 5), seed=5,
                             n_per_oct=4, smooth=smooth, thr_max=30.0,
                             channels="grad_hist_4_u1+grad_mag_u1")
    images = noise_frames(2, hw, seed=23)
    fj, _ = jax_detector(jm, hw, k=4096)
    rj, sj, vj, cj, nwj = (np.asarray(a) for a in fj(jnp.asarray(images)))
    outs = []
    for nms_iou in (None, 0.5):
        ft, packed = wt.make_batched_detector_boxes(
            tm, hw, k=4096, nms_iou=nms_iou, device="cpu")
        outs.append([a.numpy() for a in ft(torch.from_numpy(images))])
    assert packed.halo == 0
    for rt, st, vt, ct, nwt in outs:
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(nwt, nwj)
    assert (cj > 0).all()
    (rt, st, vt, _, _), (rk, sk, vk, ck, _) = outs
    for b in range(len(images)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))
        # JAX's candidates in extraction order: score descending, then
        # canvas index ascending, the tie order NMS depends on
        np.testing.assert_array_equal(
            sorted_rows(rk[b][vk[b]], sk[b][vk[b]]),
            host_nms_rows(rj[b][vj[b]], sj[b][vj[b]], 0.5))
    assert (vk.sum(1) < ck).any()  # NMS dropped some boxes


# -- (e) the config-5 golden -----------------------------------------------

@pytest.mark.slow
def test_fpga_golden_prefix_one_frame():
    """The 16-stage-prefix part of tests/data/torch_port_fpga_golden.npz
    (scripts/make_torch_fpga_golden.py) for frame 0 of both committed FPGA
    models, through the plain versions on the CPU: survivor count, n_weak,
    the boxes and scores NMS 0.5 keeps (against the JAX package's host
    NMS of the same survivors), and Model.detect's survivors."""
    g = np.load(GOLDEN)
    hw = tuple(int(v) for v in g["hw"])
    frame = np.random.RandomState(int(g["seed"])).randint(
        0, 256, (int(g["n_frames"]),) + hw).astype(np.uint8)[:1]
    for name in FPGA_MODELS:
        full = wt.load(os.path.join(ROOT, "models", name + ".pb"),
                       device="cpu")
        P = int(g[name + "_prefix_stages"])
        pm = wt.model_from_stages(full.shape, full.channel_opts,
                                  full.stages[:P], full.theta[:P],
                                  device="cpu")
        fn, _ = wt.make_batched_detector_boxes(
            pm, hw, k=int(g["k"]), nms_iou=float(g["nms_iou"]), device="cpu")
        rects, scores, valid, count, n_weak = (
            a.numpy() for a in fn(torch.from_numpy(frame)))
        assert count[0] == g[name + "_prefix_count"][0] > 0
        assert n_weak[0] == g[name + "_prefix_n_weak"][0]
        key = name + "_prefix_kept_host"
        kept = np.split(g[key + "_rows"],
                        np.cumsum(g[key + "_counts"])[:-1])[0]
        np.testing.assert_array_equal(
            sorted_rows(rects[0][valid[0]], scores[0][valid[0]]),
            sorted_rows(kept[:, :4], kept[:, 4]))
        det = np.split(g[name + "_prefix_detect_rows"],
                       np.cumsum(g[name + "_prefix_detect_counts"])[:-1])[0]
        boxes = pm.detect(frame[0])
        np.testing.assert_array_equal(
            sorted_rows(boxes.get(), boxes.get_field("scores")),
            sorted_rows(det[:, :4], det[:, 4]))
