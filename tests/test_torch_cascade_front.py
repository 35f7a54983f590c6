"""PyTorch port, kernel B3f's dense front (``csrc/cascade_fast.cu``) on
the CPU: the front's records (``ops/cascade.py::front_records``) decoded
back to the stage tables as offsets in a staged tile's strides, the stages
the front runs for each committed model, and a torch emulation of the
kernel's two phases (the front over staged tiles of origins, reading each
feature at the tile-local element ``tb + offset`` of a zero-filled
footprint, then the rest of the walk from (next stage, hs)) held bitwise
against ``cascade_masked_plain`` and against JAX's
``cascade_masked_grid_static(fast=True)`` in interpret mode."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldboost_tpu.ops.cascade_static import (cascade_masked_grid_static,
                                              static_cascade_from_model)

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import packing
from waldboost_tpu_torch.ops import cascade as tc
from waldboost_tpu_torch.ops import cascade_static as tcs

from chip_smoke import b3f_edge_models, static_operands
from torch_port_util import make_model_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tile of the committed source (its kTR, kTC, which the library
#: reports through wb_cascade_fast_tile) and the sweep's other tiles
TILES = [(16, 64), (8, 32), (32, 64), (16, 128), (8, 64)]
TILE = TILES[0]


def _model(name):
    path = os.path.join(ROOT, "models", name + ".pb")
    if not os.path.exists(path):
        path = os.path.join(ROOT, "tests", "data", name + ".pb")
    return wt.load(path, device="cpu")


def test_committed_tile_matches_the_source():
    src = os.path.join(ROOT, "waldboost_tpu_torch", "csrc", "cascade_fast.cu")
    with open(src) as f:
        text = f.read()
    assert f"constexpr int kTR = {TILE[0]}, kTC = {TILE[1]};" in text


def _decode(rec: tc.FrontRecords, shape):
    """The (F, 3) (channel, row, column) of each stage's three heap nodes,
    from the records' offsets in the footprint's (or canvas's) strides."""
    C, H, W = shape
    rows, cols = (rec.fh, rec.fw) if rec.mode == tc.FRONT_STAGED else (H, W)
    r = rec.data.reshape(rec.n_stages, 12)
    off = r[:, 0:6:2].astype(np.int64)
    return np.stack([off // (rows * cols), off % (rows * cols) // cols,
                     off % cols], axis=-1), r


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name,shape", [
    ("flagship_synth_64", (4, 1112, 512)),        # VGA, window 12 x 12
    ("flagship_hard_64", (4, 1112, 512)),
    ("torch_port_s1_synth_64", (4, 2872, 768)),   # shrink 1, 24 x 24
    ("fpga_4k_synth_64", (5, 1112, 512)),         # C = 5
])
def test_front_records_decode_to_the_stage_tables(name, shape, tile):
    m = _model(name)
    ops = m._operands("cpu")
    window = ops.window
    rec = tc.front_records(vars(ops.sc), ops.theta,
                           np.ones(ops.sc.n_stages, bool), shape, window,
                           tile)
    fh, fw = tc.front_footprint(window, tile)
    assert (rec.fh, rec.fw, rec.tile) == (fh, fw, tuple(tile))
    assert fw % 8 == 0 and tile[1] + window[1] - 1 <= fw < \
        tile[1] + window[1] + 7 and fh == tile[0] + window[0] - 1
    staged = 2 * shape[0] * fh * fw <= tc.FRONT_FOOTPRINT_BYTES
    assert rec.mode == (tc.FRONT_STAGED if staged else tc.FRONT_GLOBAL)
    assert rec.n_stages == tc.front_stages(ops.theta, tc.FRONT_REJECTS)
    F = rec.n_stages
    heap = tc._heap2({k: v[:F] for k, v in vars(ops.sc).items()
                      if k in tc.NODE_KEYS})
    feat, r = _decode(rec, shape)
    np.testing.assert_array_equal(feat[..., 0], heap["fch"][:, :3])
    np.testing.assert_array_equal(feat[..., 1], heap["fr"][:, :3])
    np.testing.assert_array_equal(feat[..., 2], heap["fc"][:, :3])
    np.testing.assert_array_equal(r[:, 1:6:2].view(np.float32),
                                  heap["thr"][:, :3])
    np.testing.assert_array_equal(r[:, 6].view(np.float32), ops.theta[:F])
    np.testing.assert_array_equal(r[:, 7], 1)
    np.testing.assert_array_equal(r[:, 8:].view(np.float32),
                                  heap["pred"][:, 3:])
    # every feature of a tile's windows lies inside its footprint
    assert (feat[..., 1] < window[0]).all() and (feat[..., 2] <
                                                 window[1]).all()


def _global_front_matches_node_records(rec, ops, shape):
    F = tc.front_stages(ops.theta, tc.FRONT_REJECTS)
    assert rec.mode == tc.FRONT_GLOBAL and rec.n_stages == F > 0
    want = tc.node_records({k: v[:F] for k, v in vars(ops.sc).items()
                            if k in tc.NODE_KEYS}, ops.theta[:F],
                           np.ones(F, bool), shape)
    assert want[0] == tc.HEAP2
    np.testing.assert_array_equal(rec.data, want[1])


def test_front_records_global_beyond_the_footprint_budget(monkeypatch):
    monkeypatch.setattr(tc, "FRONT_FOOTPRINT_BYTES", 1024)
    ops = _model("flagship_synth_64")._operands("cpu")
    shape = (4, 1112, 512)
    rec = tc.front_records(vars(ops.sc), ops.theta, np.ones(64, bool),
                           shape, (12, 12), TILE)
    _global_front_matches_node_records(rec, ops, shape)


def test_front_records_global_off_16_bytes():
    """A canvas whose rows or base are off 16 bytes cannot be staged by
    TMA: the front's records are in the canvas's strides."""
    ops = _model("flagship_synth_64")._operands("cpu")
    shape = (4, 1112, 509)
    rec = tc.front_records(vars(ops.sc), ops.theta, np.ones(64, bool),
                           shape, (12, 12), TILE, stageable=False)
    _global_front_matches_node_records(rec, ops, shape)
    assert ops.front(shape, TILE, False).rec.mode == tc.FRONT_GLOBAL
    assert ops.front(shape, TILE).rec.mode == tc.FRONT_STAGED


@pytest.mark.parametrize("name,n_rejects,want", [
    ("flagship_synth_64", 1, 1),    # stage 0 rejects
    ("flagship_hard_64", 1, 2),     # stage 0 cannot: stages 0 and 1
    ("flagship_hard_256", 1, 1),
    ("flagship_synth_64", 2, 3),    # stage 1 cannot reject
    ("flagship_hard_64", 3, 4),
    ("fpga_4k_synth_64", 1, 3),
    ("flagship_synth_64", 0, 0),    # no front
])
def test_front_stages_of_the_committed_models(name, n_rejects, want,
                                              monkeypatch):
    monkeypatch.setattr(tc, "FRONT_REJECTS", n_rejects)
    ops = _model(name)._operands("cpu")
    assert tc.front_stages(ops.theta, n_rejects) == want
    rec = tc.front_records(vars(ops.sc), ops.theta,
                           np.ones(ops.sc.n_stages, bool),
                           (ops.n_channels, 1112, 512), ops.window, TILE)
    assert rec.n_stages == want
    assert rec.mode == (tc.FRONT_NONE if want == 0 else tc.FRONT_STAGED)


def test_front_of_cascades_that_never_reject_or_run_deep_trees(monkeypatch):
    ninf = [-np.inf] * 16
    assert tc.front_stages(np.array(ninf, np.float32), 1) == 16
    assert tc.front_stages(np.zeros(0, np.float32), 1) == 0
    models = b3f_edge_models(tcs, np.random.RandomState(5), (12, 12), 4,
                             "cpu")
    stages = {name: ops.front((4, 40, 80), TILE).rec
              for name, ops in models.items()}
    assert (stages["never16"].n_stages, stages["never16"].mode) == \
        (16, tc.FRONT_STAGED)                 # the front ends at T
    assert stages["one"].n_stages == 1
    # FRONT_REJECTS (2) stages that can reject: heap20's 0 and 2, hard20's
    # 2 and 3
    assert tc.FRONT_REJECTS == 2
    assert stages["heap20"].n_stages == 3 and stages["hard20"].n_stages == 4
    for deep in ("deep40", "big256"):         # trees deeper than 2
        assert (stages[deep].mode, stages[deep].n_stages) == \
            (tc.FRONT_NONE, 0)
    # a deep cascade whose first stage is shallow still has a front of it
    tab = {k: v.copy() for k, v in vars(models["deep40"].sc).items()}
    shallow = vars(models["heap20"].sc)
    for k in tc.NODE_KEYS:
        tab[k][0] = 0 if k not in ("left", "right") else -1
        tab[k][0, :shallow[k].shape[1]] = shallow[k][0]
    theta = models["deep40"].theta.copy()
    theta[0] = -0.5
    monkeypatch.setattr(tc, "FRONT_REJECTS", 1)
    rec = tc.front_records(tab, theta, np.ones(40, bool), (4, 40, 80),
                           (12, 12), TILE)
    assert (rec.mode, rec.n_stages) == (tc.FRONT_STAGED, 1)


# -- the two phases, emulated -------------------------------------------------

def _leaf(r, v0, v1, v2):
    f = lambda x: torch.tensor(float(np.int32(x).view(np.float32)))
    thr0, thr1, thr2 = f(r[1]), f(r[3]), f(r[5])
    p = [f(x) for x in r[8:12]]
    return torch.where(v0 <= thr0, torch.where(v1 <= thr1, p[0], p[1]),
                       torch.where(v2 <= thr2, p[2], p[3]))


def two_phase(canvas, valid, ops, tile=TILE, stageable=True):
    """What B3f computes, in torch: per ``tile`` of origins the
    footprint staged (zero off the canvas), each front feature read at the
    flat element ``tb + offset`` of it (``tb = rl * FW + cl``), hs summed
    in f32 from 0 and the windows rejected on ``!(hs >= theta)``; then the
    rest of the walk for the front's survivors from stage F with their
    hs.  Returns ``(masked, n_weak, count)``."""
    B, C, H, W = canvas.shape
    gu, gv = valid.shape
    rec = ops.front((C, H, W), tile, stageable).rec
    TR, TC = rec.tile
    fh, fw = rec.fh, rec.fw
    F = rec.n_stages
    cv = canvas.float()
    alive = valid.bool().unsqueeze(0).expand(B, gu, gv).clone()
    hs = torch.zeros((B, gu, gv), dtype=torch.float32)
    n_weak = torch.zeros(B, dtype=torch.int64)
    if rec.mode == tc.FRONT_STAGED:
        ntr, ntc = -(-gu // TR), -(-gv // TC)
        padded = torch.zeros((B, C, ntr * TR + fh, ntc * TC + fw))
        padded[:, :, :H, :W] = cv
        r = torch.arange(gu)[:, None].expand(gu, gv)
        c = torch.arange(gv)[None, :].expand(gu, gv)
        R0, C0 = r // TR * TR, c // TC * TC
        tb = (r - R0) * fw + (c - C0)

        def value(off):
            e = tb + int(off)
            ch, row, col = e // (fh * fw), e % (fh * fw) // fw, e % fw
            return padded[:, ch, R0 + row, C0 + col]
    else:  # FRONT_GLOBAL (FRONT_NONE runs no stage here)

        def value(off):
            off = int(off)
            ch, row, col = off // (H * W), off % (H * W) // W, off % W
            return cv[:, ch, row:row + gu, col:col + gv]
    recs = rec.data[:12 * F].reshape(F, 12)
    for t in range(F):
        rt = recs[t]
        resp = _leaf(rt, value(rt[0]), value(rt[2]), value(rt[4]))
        n_weak += alive.sum(dim=(1, 2)) * int(rt[7])
        hs = hs + resp              # a dead window's hs is never read
        theta = float(np.int32(rt[6]).view(np.float32))
        alive &= hs >= theta
    # the walk: the survivors from stage F with their hs
    tab = vars(ops.sc)
    zero = torch.zeros(())
    for t in range(F, ops.sc.n_stages):
        n_weak += alive.sum(dim=(1, 2))
        hs = hs + torch.where(alive, tc._stage_response(cv, tab, t, gu, gv),
                              zero)
        alive &= hs >= float(ops.theta[t])
    masked = torch.where(alive, hs, torch.tensor(float("-inf")))
    return masked, n_weak.to(torch.int32), \
        alive.sum(dim=(1, 2)).to(torch.int32)


def _bf16_canvas(rng, shape):
    vals = torch.from_numpy(rng.uniform(0, 300, shape).astype(np.float32))
    return vals.to(torch.bfloat16)


@pytest.mark.parametrize("tile", [(16, 64), (8, 32), (32, 64)])
@pytest.mark.parametrize("window,C,extra,batch", [
    ((8, 8), 1, (3, 50), 3),        # a grid under one tile
    ((12, 12), 4, (37, 140), 2),    # several tiles, partial edges
    ((24, 24), 4, (45, 101), 1),
    ((12, 12), 5, (21, 130), 2),
])
def test_two_phase_emulation_matches_plain(window, C, extra, batch, tile):
    rng = np.random.RandomState(window[0] * 100 + C + tile[0])
    shape = (batch, C, window[0] + extra[0], window[1] + extra[1])
    canvas = _bf16_canvas(rng, shape)
    valid = torch.from_numpy((rng.rand(*extra) < 0.8).astype(np.uint8))
    models = b3f_edge_models(tcs, rng, window, C, "cpu")
    del models["big256"]  # 256 deep stages: the same path as deep40
    for name, ops in models.items():
        got = two_phase(canvas, valid, ops, tile)
        want = tcs.cascade_masked_plain(canvas, valid, ops)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        assert torch.equal(want[0], tcs.cascade_masked(canvas, valid,
                                                       ops)[0])


def test_two_phase_emulation_global_front(monkeypatch):
    """The front read from the canvas (footprint beyond the budget)."""
    monkeypatch.setattr(tc, "FRONT_FOOTPRINT_BYTES", 256)
    rng = np.random.RandomState(17)
    canvas = _bf16_canvas(rng, (2, 4, 12 + 30, 12 + 90))
    valid = torch.from_numpy((rng.rand(30, 90) < 0.8).astype(np.uint8))
    for name, ops in b3f_edge_models(tcs, rng, (12, 12), 4, "cpu").items():
        if ops.front((4, 42, 102), TILE).rec.mode == tc.FRONT_NONE:
            continue
        assert ops.front((4, 42, 102), TILE).rec.mode == tc.FRONT_GLOBAL
        for g, w in zip(two_phase(canvas, valid, ops),
                        tcs.cascade_masked_plain(canvas, valid, ops)):
            assert torch.equal(g, w), name


def test_two_phase_emulation_global_front_off_16_bytes():
    """The front read from the canvas because its rows are off 16 bytes
    (a width of 101 bfloat16 values)."""
    rng = np.random.RandomState(18)
    canvas = _bf16_canvas(rng, (2, 4, 12 + 30, 12 + 89))
    valid = torch.from_numpy((rng.rand(30, 89) < 0.8).astype(np.uint8))
    for name, ops in b3f_edge_models(tcs, rng, (12, 12), 4, "cpu").items():
        mode = ops.front((4, 42, 101), TILE, False).rec.mode
        assert mode in (tc.FRONT_NONE, tc.FRONT_GLOBAL), name
        for g, w in zip(two_phase(canvas, valid, ops, stageable=False),
                        tcs.cascade_masked_plain(canvas, valid, ops)):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("hw,npo,shape,open_stages", [
    ((48, 64), 2, (8, 8, 4), 0),
    ((57, 83), 2, (8, 8, 4), 3),     # stages 0-2 cannot reject
    ((96, 128), 2, (12, 12, 4), 0),
])
def test_two_phase_emulation_matches_jax(hw, npo, shape, open_stages):
    """The emulation over a bfloat16 canvas against JAX's B3f in interpret
    mode (``with_n_weak=False``): the same finite set, scores and counts,
    as ``tests/test_torch_fast.py::test_cascade_fast_matches_jax`` holds
    the plain version."""
    jm, tm = make_model_pair(n_stages=20, shape=shape, seed=4,
                             n_per_oct=npo, open_stages=open_stages)
    window = shape[:2]
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, npo, window,
                                         halo=1)
    rng = np.random.RandomState(7)
    canvas = _bf16_canvas(rng, (2, 4, packed.canvas_h, packed.canvas_w))
    valid = packed.valid_mask(window)
    ops = tcs.CascadeOperands.build(tcs.static_cascade_from_model(tm),
                                    window, 4, "cpu")
    # stages 0 .. the second stage that can reject (odd stages from
    # open_stages on)
    assert ops.front(tuple(canvas.shape[1:]), TILE).rec.n_stages == \
        {0: 4, 3: 6}[open_stages]
    vt = torch.from_numpy(valid.astype(np.uint8))
    masked, n_weak, count = two_phase(canvas, vt, ops)
    cj = jnp.asarray(canvas.float().numpy()).astype(jnp.bfloat16)
    mj, _, cnt_j = cascade_masked_grid_static(
        cj, static_cascade_from_model(jm), jnp.asarray(valid), window,
        interpret=True, with_n_weak=False, fast=True)
    gu, gv = valid.shape
    mj = np.asarray(mj)[:, :gu, :gv]
    alive = np.isfinite(masked.numpy())
    np.testing.assert_array_equal(alive, np.isfinite(mj))
    np.testing.assert_array_equal(masked.numpy()[alive], mj[alive])
    np.testing.assert_array_equal(count.numpy(), np.asarray(cnt_j))
    assert 0 < int(count.sum()) < 2 * valid.sum()
    for a, b in zip((masked, n_weak, count),
                    tcs.cascade_masked_plain(canvas, vt, ops)):
        assert torch.equal(a, b)


def test_static_operands_match_the_model_path():
    """chip_smoke.static_operands (the edge models) builds what a model's
    own operands hold."""
    m = _model("flagship_synth_64")
    ops = m._operands("cpu")
    mine = static_operands(tcs, m.stages, m.theta, (12, 12), 4, "cpu")
    for k in tc.NODE_KEYS:
        np.testing.assert_array_equal(getattr(mine.sc, k),
                                      getattr(ops.sc, k))
    np.testing.assert_array_equal(mine.theta, ops.theta)
