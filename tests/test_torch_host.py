"""PyTorch port, host layer: model files, pyramid geometry and plane taps
held exactly against the JAX package; the port's import stays free of
jax; unported options raise."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import model as M
from waldboost_tpu.channels import pyramid_plan as jax_pyramid_plan
from waldboost_tpu.ops.channels_pallas import plane_pad_geometry
from waldboost_tpu.ops.exact import axis_taps_exact as jax_taps

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import model_io, packing, polyphase
from waldboost_tpu_torch.ops.exact import axis_taps_exact

from torch_port_util import make_model_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["flagship_synth_64", "flagship_hard_64", "flagship_hard_256"]
SIZES = [(48, 64), (96, 128), (160, 256), (480, 640), (1080, 1920)]


def _assert_models_equal(jm, tm):
    assert tm.shape == jm.shape
    for key in ("shrink", "n_per_oct", "smooth"):
        assert tm.channel_opts[key] == jm.channel_opts[key]
    assert tm.channel_opts["channels"].name == jm.channel_opts["channels"].name
    assert len(tm) == len(jm)
    np.testing.assert_array_equal(np.asarray(tm.theta, np.float32),
                                  np.asarray(jm.theta, np.float32))
    for stage, weak in zip(tm.stages, jm.classifier):
        ref = weak.to_stage_dict()
        for key in ("feature", "threshold", "left", "right", "prediction"):
            assert stage[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(stage[key], ref[key])


@pytest.mark.parametrize("name", MODELS)
def test_model_file_matches_jax(name, tmp_path):
    """Field for field equal to Model.load; re-encoding reproduces the
    protobuf serializer's bytes; a file the port saves loads in JAX."""
    path = os.path.join(ROOT, "models", name + ".pb")
    jm = wb.load(path)
    tm = wt.load(path)
    _assert_models_equal(jm, tm)
    with open(path, "rb") as f:
        raw = zlib.decompress(f.read())
    assert model_io.encode_model(tm.to_message()) == raw
    out = str(tmp_path / "port.pb")
    tm.save(out)
    _assert_models_equal(wb.load(out), tm)


def test_model_roundtrip_random_cascade(tmp_path):
    jm, tm = make_model_pair(n_stages=5, seed=3)
    jpath, tpath = str(tmp_path / "j.pb"), str(tmp_path / "t.pb")
    jm.save(jpath)
    tm.save(tpath)
    _assert_models_equal(jm, wt.load(jpath))
    _assert_models_equal(wb.load(tpath), tm)
    with open(jpath, "rb") as f1, open(tpath, "rb") as f2:
        assert zlib.decompress(f1.read()) == zlib.decompress(f2.read())


@pytest.mark.parametrize("payload", [b"not a model", zlib.compress(b"\xff"),
                                     zlib.compress(b"\x0a\x05\x01")])
def test_corrupt_model_raises_value_error(payload, tmp_path):
    path = tmp_path / "bad.pb"
    path.write_bytes(payload)
    with pytest.raises(ValueError):
        wb.load(str(path))
    with pytest.raises(ValueError):
        wt.load(str(path))


@pytest.mark.parametrize("n_per_oct", [2, 4, 8])
@pytest.mark.parametrize("hw", SIZES)
def test_geometry_matches_jax(hw, n_per_oct):
    """Pyramid plan, packed plan, masks, level maps, band rows, exact taps
    and per-level plane geometry equal the JAX package's."""
    h, w = hw
    window = (12, 12)
    assert tch.pyramid_plan(h, w, 2, n_per_oct) == tuple(
        tch.Level(**vars(lv)) for lv in jax_pyramid_plan(h, w, 2, n_per_oct))
    jp = M._packed_plan_cached(h, w, 2, n_per_oct, window, halo=1)
    tp = packing._packed_plan_cached(h, w, 2, n_per_oct, window, halo=1)
    assert (tp.canvas_h, tp.canvas_w, tp.shrink, tp.halo, tp.window,
            tp.bands) == (jp.canvas_h, jp.canvas_w, jp.shrink, jp.halo,
                          jp.window, jp.bands)
    assert [(pl.plan_index, pl.y, pl.x, pl.band, pl.col, vars(pl.level))
            for pl in tp.levels] == \
        [(pl.plan_index, pl.y, pl.x, pl.band, pl.col, vars(pl.level))
         for pl in jp.levels]
    np.testing.assert_array_equal(tp.smooth_interior_mask(),
                                  jp.smooth_interior_mask())
    for win in (window, (8, 8)):
        np.testing.assert_array_equal(tp.valid_mask(win), jp.valid_mask(win))
        for a, b in zip(tp.level_maps(win), jp.level_maps(win)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    pr, _pc, PH, _PW = plane_pad_geometry(jp.canvas_h, jp.canvas_w)
    for he2, pr_, PH_ in ((1, pr, PH), (0, 0, jp.canvas_h)):
        assert packing._band_rows(tp, he2, pr_, PH_) == \
            M._band_rows(jp, he2, pr_, PH_)
    for pl in jp.levels:
        lv = pl.level
        for n_out, n_in in ((lv.height, h >> lv.octave),
                            (lv.width, w >> lv.octave)):
            for a, b in zip(axis_taps_exact(n_in, n_out),
                            jax_taps(n_in, n_out)):
                np.testing.assert_array_equal(a, b)
    for tg, jg in zip(polyphase._poly_geom_levels(tp, tp.halo, hw),
                      M._poly_geom_levels(jp, jp.halo, hw)):
        for key, val in tg.items():
            np.testing.assert_array_equal(val, jg[key], err_msg=key)


def test_plane_tables_place_levels_at_band_rows():
    """The plane kernel's tables put level li at (pl.y - halo/2,
    pl.x - halo/2) with a (hq, wq) block inside the canvas, and the block
    table covers every element of every level exactly once."""
    tp = packing._packed_plan_cached(480, 640, 2, 8, (12, 12), halo=1)
    tables = polyphase.plane_tables(tp, tp.halo, (480, 640))
    cols = polyphase.META_COLS
    meta = {c: tables.meta[:, i] for i, c in enumerate(cols)}
    he2 = tp.halo // 2
    np.testing.assert_array_equal(meta["y0"], [pl.y - he2 for pl in tp.levels])
    np.testing.assert_array_equal(meta["x0"], [pl.x - he2 for pl in tp.levels])
    assert (meta["y0"] + meta["hq"] <= tp.canvas_h).all()
    assert (meta["x0"] + meta["wq"] <= tp.canvas_w).all()
    covered = np.zeros(len(tp.levels), np.int64)
    for li, e0 in tables.blocks:
        covered[li] += min(polyphase.PLANE_BLOCK, meta["elems"][li] - e0)
    np.testing.assert_array_equal(covered, meta["elems"])


def test_port_import_leaves_jax_out():
    code = ("import sys; before = set(sys.modules); "
            "import waldboost_tpu_torch; "
            "import waldboost_tpu_torch.parallel.detect; "
            "import waldboost_tpu_torch.model, waldboost_tpu_torch.boxes, "
            "waldboost_tpu_torch.canvas, waldboost_tpu_torch.device, "
            "waldboost_tpu_torch.ops.cascade, "
            "waldboost_tpu_torch.ops.cascade_static, "
            "waldboost_tpu_torch.ops.nms, waldboost_tpu_torch.fpga, "
            "waldboost_tpu_torch.ops.fpga; "
            "waldboost_tpu_torch.channels.resolve_channel_function("
            "'grad_hist_4_u1+grad_mag_u1'); "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'waldboost_tpu', 'google')); "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_unported_options_raise():
    _, tm = make_model_pair(n_stages=2)
    with pytest.raises(NotImplementedError, match="A14"):
        tch.resolve_channel_function("grad_mag")
    for kwargs, item in ((dict(mesh=object()), "A11"),
                         (dict(two_phase=True), "A13"),
                         (dict(fast=True), "A6"),
                         (dict(n_scales=1), "A4")):
        with pytest.raises(NotImplementedError, match=item):
            wt.make_batched_detector_boxes(tm, (48, 64), device="cpu",
                                           **kwargs)
    with pytest.raises(ValueError):
        wt.make_batched_detector_boxes(tm, (48, 64), n_scales=0,
                                       device="cpu")
    fn, _ = wt.make_batched_detector_boxes(tm, (48, 64), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        fn(torch.zeros((1, 48, 64), dtype=torch.float32))
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 40, 64), dtype=torch.uint8))
