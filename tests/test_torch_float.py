"""PyTorch port, exact float frames on the CPU: the float64 plane build
(``ops/planes.py::planes_float``), kernel B2d's plain version
(``ops/channels.py::grad_hist_float_plain``), the FPGA family's float
chain and the serving entries, held against ``tests/oracle.py`` (the
reference's own float64 arithmetic) and against the JAX package on the
same seeded inputs.

The JAX package emulates float64 in double-float pairs (``ops/dd.py``),
which is more precise than float64: where a lerp lands near a float32
midpoint its planes can take the other neighbour.  The port computes in
native float64, as the oracle does, so its planes and canvas are bitwise
the oracle's, and they differ from JAX's in a few values by an ULP.
Measured here (numpy seeds below): planes 0.023-0.037% of the elements
at 1 ULP; the canvases of the frames at most 9 ULP, 99.72-99.79%
bitwise (a plane's ULP reaches every gradient that reads it); B2d on the
same planes bitwise against JAX's Pallas kernel and XLA chain inside
every level.  Outside the levels, with ``smooth == 0``, 34-38 values
differ, all with both sides below 2**-30 (the exact-cancellation class
of PARITY.md §1c: bin 2's cos is 6.1e-17, not 0); no window reads them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_model
from waldboost_tpu import model as JM
from waldboost_tpu.channels import _normalize_opts
from waldboost_tpu.ops.channels_pallas import grad_hist_poly_pallas
from waldboost_tpu.parallel.detect import \
    make_batched_detector_boxes as jax_detector
from waldboost_tpu.polyphase import _poly_channels, _poly_planes

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import packing, polyphase
from waldboost_tpu_torch.canvas import as_image
from waldboost_tpu_torch.ops import channels as tcc
from waldboost_tpu_torch.ops import planes as tpl

import oracle
from torch_port_util import make_model_pair, sorted_rows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = 2.0 ** -30


def float_noise(n, hw, seed):
    """uint8 noise plus uniform [0, 1) noise, float32."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n,) + tuple(hw))
            + rng.rand(n, *hw)).astype(np.float32)


def float_scenes(n, hw, seed):
    """Crops of the golden VGA scene frames plus uniform [0, 1) noise."""
    frames = np.load(os.path.join(ROOT, "tests", "data",
                                  "torch_port_vga_golden.npz"))["frames"]
    h, w = hw
    crops = frames[:n, 100:100 + h, 200:200 + w].astype(np.float64)
    return (crops + np.random.RandomState(seed).rand(*crops.shape)) \
        .astype(np.float32)


INPUTS = {"noise": (float_noise, (96, 128), 4),
          "scene": (float_scenes, (120, 160), 4)}


def ulp(a, b) -> np.ndarray:
    """ULP distance of two float32 arrays (monotone integer mapping)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def setup(kind, smooth=1):
    """Frames, JAX and port plans, the port's octaves and planes."""
    make, hw, npo = INPUTS[kind]
    imgs = make(2, hw, seed=len(kind))
    opts = dict(shrink=2, n_per_oct=npo, smooth=smooth, channels="grad_hist")
    cf = _normalize_opts(opts)[3]
    jp = JM._packed_plan_cached(hw[0], hw[1], 2, npo, (8, 8), halo=cf.halo)
    tp = packing._packed_plan_cached(hw[0], hw[1], 2, npo, (8, 8), halo=1)
    tables = polyphase.float_plane_tables(tp, tp.halo, hw)
    octl = tch.level_octaves(torch.from_numpy(imgs), len(tables.oct_hw))
    planes = tpl.planes_float(tpl.octave_buffer(octl),
                              tpl.FloatPlaneOperands.build(tables, "cpu"))
    return imgs, cf, jp, tp, octl, planes


def level_image(planes_b, pl):
    """(h, w) image of a level cut out of one (2, 2, PH, PW) plane canvas
    (image pixel (2i + a, 2j + q) is plane (a, q) at (y + i, x + j))."""
    lv = pl.level
    blk = planes_b[:, :, pl.y:pl.y + lv.height // 2,
                   pl.x:pl.x + lv.width // 2]
    return blk.transpose(2, 0, 3, 1).reshape(lv.height, lv.width)


def level_mask(packed) -> np.ndarray:
    inside = np.zeros((packed.canvas_h, packed.canvas_w), bool)
    for pl in packed.levels:
        inside[pl.y:pl.y + pl.level.out_height,
               pl.x:pl.x + pl.level.out_width] = True
    return inside


# -- planes ---------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_planes_float_match_oracle(kind):
    """Every level of the plane canvas equals the oracle's float64
    two-pass lerp of its octave (``resize_bilinear``'s float branch)."""
    imgs, _, _, tp, octl, planes = setup(kind)
    P = planes.numpy()
    for b in range(len(imgs)):
        for pl in tp.levels:
            lv = pl.level
            want = oracle.resize_bilinear(octl[lv.octave][b].numpy(),
                                          lv.height, lv.width)
            np.testing.assert_array_equal(level_image(P[b], pl), want)


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_planes_float_near_jax(kind):
    """Against JAX's double-float planes: at most 1 ULP, in under 0.1% of
    the elements (measured: 0.017-0.035%)."""
    imgs, cf, jp, _, _, planes = setup(kind)
    for b in range(len(imgs)):
        want = np.asarray(_poly_planes(jnp.asarray(imgs[b]), cf, jp))
        u = ulp(planes[b].numpy(), want)
        share = (u > 0).mean()
        print(f"{kind} frame {b}: planes max {u.max()} ULP, "
              f"{100 * share:.4f}% differ")
        assert u.max() <= 1 and share < 1e-3


# -- B2d ------------------------------------------------------------------

@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_grad_hist_float_matches_jax(kind, smooth):
    """B2d's plain version against grad_hist_poly_pallas(interpret=True)
    (the float_dd variant) and polyphase._poly_channels' XLA float chain
    on the same float32 planes: bitwise inside every level; outside them
    (smooth 0) only values with both sides below 2**-30 differ."""
    _, cf, jp, tp, _, planes = setup(kind, smooth)
    mask = tp.smooth_interior_mask()
    got = tcc.grad_hist_float(
        planes, torch.from_numpy(mask.astype(np.uint8)) if smooth else None,
        smooth).numpy()
    pj = jnp.asarray(planes.numpy())
    inside = level_mask(tp)
    for name, want in (
            ("pallas", grad_hist_poly_pallas(
                pj, jnp.asarray(mask) if smooth else None, smooth,
                interpret=True)),
            ("xla", _poly_channels(pj, smooth, cf, jp))):
        want = np.asarray(want)[..., :got.shape[-2], :got.shape[-1]]
        differ = got != want
        print(f"{kind} smooth {smooth} {name}: {int(differ.sum())} of "
              f"{got.size} differ")
        assert not differ[:, :, inside].any()
        assert (np.abs(got[differ]) < TINY).all()
        assert (np.abs(want[differ]) < TINY).all()
        if smooth:
            assert not differ.any()


@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_grad_hist_float_matches_oracle(kind, smooth):
    """Each level of the B2d canvas equals the oracle's per-level
    grad_hist (scipy's float64 accumulation, the float64-promoted
    projection), 2x2 pool and smooth, bitwise."""
    imgs, _, _, tp, octl, planes = setup(kind, smooth)
    mask = torch.from_numpy(tp.smooth_interior_mask().astype(np.uint8))
    canvas = tcc.grad_hist_float_plain(planes, mask if smooth else None,
                                       smooth).numpy()
    for b in range(len(imgs)):
        for pl in tp.levels:
            lv = pl.level
            chns = oracle.avg_pool_2(oracle.grad_hist(oracle.resize_bilinear(
                octl[lv.octave][b].numpy(), lv.height, lv.width)))
            if smooth:
                chns = oracle.smooth_image_3d(chns)
            got = canvas[b, :, pl.y:pl.y + lv.out_height,
                         pl.x:pl.x + lv.out_width].transpose(1, 2, 0)
            np.testing.assert_array_equal(got, chns)


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_float_canvas_near_jax(kind):
    """Frames to canvas against JAX's exact float canvas (double-float
    planes, XLA chain): within PARITY.md's 16-ULP float contract.  The
    planes' 1-ULP differences reach each gradient that reads them, so
    fewer values are bitwise than on equal planes (measured: at most 9
    ULP, 99.72-99.79% bitwise); held to 99.5%."""
    imgs, cf, jp, tp, _, planes = setup(kind)
    mask = torch.from_numpy(tp.smooth_interior_mask().astype(np.uint8))
    got = tcc.grad_hist_float(planes, mask, 1).numpy()
    for b in range(len(imgs)):
        want = np.asarray(_poly_channels(
            _poly_planes(jnp.asarray(imgs[b]), cf, jp), 1, cf, jp))
        u = ulp(got[b], want)
        share = (u == 0).mean()
        print(f"{kind} frame {b}: canvas max {u.max()} ULP, "
              f"{100 * share:.4f}% bitwise")
        assert u.max() <= 16 and share >= 0.995


@pytest.mark.parametrize("hw", [(3, 5), (17, 45)])
def test_grad_hist_float_small_shapes(hw):
    """Canvases smaller than one kernel tile: the plain version against
    JAX's Pallas kernel on seeded planes, bitwise, with an interior mask
    that is 0 on the canvas's ring, as every level's is (off the canvas
    the port's pooled values read 0, JAX's those of its padded tile)."""
    rng = np.random.RandomState(hw[0])
    planes = (rng.rand(2, 2, 2, *hw) * 256).astype(np.float32)
    mask = (rng.rand(*hw) < 0.9)
    mask[[0, -1]] = False
    mask[:, [0, -1]] = False
    got = tcc.grad_hist_float(torch.from_numpy(planes),
                              torch.from_numpy(mask.astype(np.uint8)),
                              1).numpy()
    want = np.asarray(grad_hist_poly_pallas(
        jnp.asarray(planes), jnp.asarray(mask), 1, interpret=True))
    np.testing.assert_array_equal(got, want[..., :hw[0], :hw[1]])


def test_as_image_types():
    img = float_noise(1, (20, 30), seed=1)[0]
    np.testing.assert_array_equal(as_image(img.astype(np.float64)), img)
    assert as_image(img).dtype == np.float32
    assert as_image(img.astype(np.uint8)).dtype == np.uint8
    with pytest.raises(ValueError):
        as_image(img.astype(np.int16))
    with pytest.raises(ValueError):
        as_image(img[None])


# -- serving ----------------------------------------------------------------

def column_rows(*cols) -> np.ndarray:
    """Float32 rows of the given columns in lexicographic order."""
    cols = [np.asarray(c, np.float32) for c in cols]
    rows = np.concatenate([c.reshape(len(c), -1) for c in cols], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def box_set(boxes):
    return set(map(tuple, np.concatenate(
        [boxes.get(), boxes.get_field("scores")[:, None]], 1)))


def assert_flips(want, got, what):
    """At most 0.5% of the union in one set only or with another score
    (PARITY.md's float bound); none where the inputs give none."""
    flips = len(want ^ got)
    print(f"{what}: {len(want)} boxes, {flips} flips")
    assert flips <= 0.005 * max(len(want | got), 1)


@pytest.mark.parametrize("smooth", [0, 1])
def test_float_serving_matches_jax(smooth):
    """Float frames through Model.detect, make_batched_detector_boxes
    (NMS 0.5) and wt.detect against JAX's Model.detect and batched
    detector, on a random cascade that keeps thousands of windows
    (measured: 0 flips in every case)."""
    jm, tm = make_model_pair(n_stages=8, seed=2, n_per_oct=2, smooth=smooth)
    hw = (96, 128)
    imgs = float_noise(3, hw, seed=3)
    for b, im in enumerate(imgs):
        want = box_set(jm.detect(im))
        assert len(want) > 1000
        assert_flips(want, box_set(tm.detect(im)), f"Model.detect {b}")
        multi = wt.detect(im, tm, tm, response_scale=[1.0, 0.5])
        lab = multi.get_field("label")
        first = wt.Boxes(multi.get()[lab == 0])
        first.set_field("scores", multi.get_field("scores")[lab == 0])
        assert_flips(want, box_set(first), f"wt.detect {b}")
    fj, _ = jax_detector(jm, hw, k=4096, nms_iou=0.5)
    rj, sj, vj, cj, nwj = (np.asarray(a) for a in fj(jnp.asarray(imgs)))
    ft, _ = wt.make_batched_detector_boxes(tm, hw, k=4096, nms_iou=0.5,
                                           device="cpu")
    rt, st, vt, ct, nwt = (a.numpy() for a in ft(torch.from_numpy(imgs)))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nwt, nwj)
    for b in range(len(imgs)):
        np.testing.assert_array_equal(sorted_rows(rt[b][vt[b]], st[b][vt[b]]),
                                      sorted_rows(rj[b][vj[b]], sj[b][vj[b]]))


def test_float_entries_match_jax():
    """Float frames on the other serving entries, against their JAX
    counterparts on the same frames: detect_topk (k, NMS),
    make_batched_detector's maps and n_weak, make_multi_detector_boxes
    over two models, detect_batch and scan_packed (bitwise: these inputs
    give no flip)."""
    from waldboost_tpu.parallel import detect as jdet
    jm, tm = make_model_pair(n_stages=8, seed=2, n_per_oct=2, smooth=1)
    jm2, tm2 = make_model_pair(n_stages=6, seed=7, n_per_oct=2, smooth=1)
    hw = (48, 64)
    imgs = float_noise(2, hw, seed=4)
    want = jm.detect_topk(imgs[0], k=256, nms_iou=0.5)
    got = tm.detect_topk(imgs[0], k=256, nms_iou=0.5)
    assert box_set(got) == box_set(want) and len(want) > 10
    fj = jdet.make_batched_detector(jm, hw)[0]
    ft, _ = wt.make_batched_detector(tm, hw, device="cpu")
    for a, b in zip(ft(torch.from_numpy(imgs)), fj(jnp.asarray(imgs))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fj, _ = jdet.make_multi_detector_boxes([jm, jm2], hw, k=4096,
                                           nms_iou=0.5)
    ft, _ = wt.make_multi_detector_boxes([tm, tm2], hw, k=4096,
                                         nms_iou=0.5, device="cpu")
    rj, sj, vj, lj, cj, nj = (np.asarray(a) for a in fj(jnp.asarray(imgs)))
    rt, st, vt, lt, ct, nt = (a.numpy() for a in ft(torch.from_numpy(imgs)))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nt, nj)
    for b in range(len(imgs)):
        np.testing.assert_array_equal(
            column_rows(rt[b][vt[b]], st[b][vt[b]], lt[b][vt[b]]),
            column_rows(rj[b][vj[b]], sj[b][vj[b]], lj[b][vj[b]]))
    for got, im in zip(wt.detect_batch(tm, imgs), imgs):
        assert box_set(got) == box_set(jm.detect(im))
    _, _, rs, cs, hs = tm.scan_packed(imgs[1])
    _, _, jrs, jcs, jhs = jm.scan_packed(imgs[1])
    np.testing.assert_array_equal(column_rows(rs, cs, hs),
                                  column_rows(jrs, jcs, jhs))


def test_float_serving_flagship_model():
    """tests/test_bucketed.py's 12-stage flagship cascade on float frames
    (uint8 noise plus a fraction; seeds 5 and 8 keep 2 windows each, most
    keep none): the port's Model.detect equals JAX's, boxes and
    scores."""
    jm = _flagship_model(seed=0, n_stages=12, shape=(8, 8, 4),
                         image_hw=(96, 128),
                         channel_opts=dict(shrink=2, n_per_oct=4, smooth=1,
                                           channels="grad_hist"))
    tm = wt.model_from_stages(jm.shape, jm.channel_opts,
                              [w.to_stage_dict() for w in jm.classifier],
                              jm.theta, device="cpu")
    for seed in (5, 8):
        im = float_noise(1, (90, 115), seed=seed)[0]
        want, got = box_set(jm.detect(im)), box_set(tm.detect(im))
        assert want == got and len(want) > 0


def test_fpga_float_frames_match_jax():
    """An FPGA model on float frames: JAX runs its FPGA chain on the float
    planes in XLA; the port's plain-torch chain gives the same boxes."""
    jm, tm = make_model_pair(n_stages=6, shape=(8, 8, 5), seed=5,
                             n_per_oct=2, smooth=1, thr_max=40.0,
                             channels="grad_hist_4_u1+grad_mag_u1")
    for b, im in enumerate(float_noise(2, (64, 96), seed=9)):
        want, got = box_set(jm.detect(im)), box_set(tm.detect(im))
        assert len(want) > 0
        assert_flips(want, got, f"FPGA float frame {b}")


def test_float_golden_vga():
    """The committed float golden (scripts/make_torch_bucket_golden.py):
    the 3 VGA scene frames as float32 through make_batched_detector_boxes
    (k=1024, NMS 0.5) and Model.detect of flagship_synth_64 equal JAX's
    bitwise (the inputs give no flip)."""
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "torch_port_float_golden.npz"))
    frames = np.load(os.path.join(ROOT, "tests", "data",
                                  "torch_port_vga_golden.npz"))["frames"]
    frames = frames.astype(np.float32)
    model = wt.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"),
                    device="cpu")
    fn, _ = wt.make_batched_detector_boxes(model, frames.shape[1:],
                                           k=int(g["k"]),
                                           nms_iou=float(g["nms_iou"]),
                                           device="cpu")
    rects, scores, valid, count, _ = (a.numpy()
                                      for a in fn(torch.from_numpy(frames)))
    np.testing.assert_array_equal(count, g["batched_counts"])
    kept = np.split(g["batched_kept"], np.cumsum(g["batched_kept_counts"])[:-1])
    raw = np.split(g["detect_rows"], np.cumsum(g["detect_counts"])[:-1])
    for b in range(len(frames)):
        np.testing.assert_array_equal(
            sorted_rows(rects[b][valid[b]], scores[b][valid[b]]),
            sorted_rows(kept[b][:, :4], kept[b][:, 4]))
        bx = model.detect(frames[b])
        np.testing.assert_array_equal(
            sorted_rows(bx.get(), bx.get_field("scores")),
            sorted_rows(raw[b][:, :4], raw[b][:, 4]))
