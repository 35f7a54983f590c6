"""PyTorch port, cascade tables: the runtime ``Cascade`` of
``cascade_from_stages`` (internal-first reorder, complete heaps, stage
padding with ``active``) and the frozen ``StaticCascade`` equal the JAX
package's field for field on the same stage dicts."""

import os

import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu.ops import cascade as jc
from waldboost_tpu.ops.cascade_static import \
    static_cascade_from_model as jax_static

import waldboost_tpu_torch as wt
from waldboost_tpu_torch.ops import cascade as tc
from waldboost_tpu_torch.ops import cascade_static as tcs

from test_cascade import random_stage
from torch_port_util import make_model_pair, random_deep_stage

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("fr", "fc", "fch", "thr", "left", "right", "pred", "theta",
          "active")


def _assert_cascades_equal(jcasc, jmeta, tcasc, tmeta):
    assert tuple(tmeta) == tuple(jmeta)
    for f in FIELDS:
        want = np.asarray(getattr(jcasc, f))
        got = getattr(tcasc, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _stages(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "deep":
        return [random_deep_stage(rng, (8, 8), 4) for _ in range(n)]
    if kind == "mixed":
        return [random_stage(rng, (8, 8), 4, "stump" if t % 3 else "depth2")
                for t in range(n)]
    return [random_stage(rng, (8, 8), 4, kind) for _ in range(n)]


@pytest.mark.parametrize("n_stages", [None, 16, 64])
@pytest.mark.parametrize("kind,n", [("depth2", 11), ("stump", 5),
                                    ("mixed", 9), ("deep", 13), ("deep", 0)])
def test_cascade_from_stages_matches_jax(kind, n, n_stages):
    stages = _stages(kind, n, seed=n)
    rng = np.random.RandomState(1)
    thetas = [-np.inf if t % 2 else float(rng.randn()) for t in range(n)]
    jcasc, jmeta = jc.cascade_from_stages(stages, thetas, n_stages=n_stages)
    tcasc, tmeta = tc.cascade_from_stages(stages, thetas, n_stages=n_stages,
                                          device="cpu")
    _assert_cascades_equal(jcasc, jmeta, tcasc, tmeta)
    assert tmeta.complete == (kind != "deep" and n > 0)


def test_cascade_from_stages_general_nodes_matches_jax():
    """``n_nodes`` keeps shallow trees in the general (reordered) form."""
    stages = _stages("depth2", 6, seed=3)
    thetas = [0.1 * t - 1 for t in range(6)]
    _assert_cascades_equal(
        *jc.cascade_from_stages(stages, thetas, n_nodes=9, n_stages=8),
        *tc.cascade_from_stages(stages, thetas, n_nodes=9, n_stages=8,
                                device="cpu"))


def test_stage_bucket_matches_jax():
    for T in list(range(0, 70)) + [127, 128, 129, 256, 257]:
        assert wt.Model._stage_bucket(T) == wb.Model._stage_bucket(T), T


@pytest.mark.parametrize("depth", [None, 5])
@pytest.mark.parametrize("n_stages", [3, 33])
def test_model_tables_match_jax(n_stages, depth):
    """Model._get_cascade pads to the stage bucket exactly as JAX does, and
    static_cascade_from_model keeps the file's node order unpadded."""
    jm, tm = make_model_pair(n_stages=n_stages, seed=5, depth=depth)
    _assert_cascades_equal(*jm._get_cascade(), *tm._get_cascade())
    js, ts = jax_static(jm), tcs.static_cascade_from_model(tm)
    for f in ("fr", "fc", "fch", "thr", "left", "right", "pred", "theta"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)


@pytest.mark.parametrize("name", ["flagship_synth_64", "flagship_hard_64",
                                  "flagship_hard_256"])
def test_committed_model_tables_match_jax(name):
    path = os.path.join(ROOT, "models", name + ".pb")
    jm, tm = wb.load(path), wt.load(path, device="cpu")
    _assert_cascades_equal(*jm._get_cascade(), *tm._get_cascade())
    js, ts = jax_static(jm), tcs.static_cascade_from_model(tm)
    for f in ("fr", "fc", "fch", "thr", "left", "right", "pred", "theta"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))


def test_cascade_tables_checked():
    stages = _stages("deep", 3, seed=2)
    casc, _ = tc.cascade_from_stages(stages, [0.0] * 3, device="cpu")
    left = casc.left.clone()
    left[1, 0] = 0  # the root is its own child
    with pytest.raises(ValueError, match="child"):
        tc.Cascade(casc.fr, casc.fc, casc.fch, casc.thr, left, casc.right,
                   casc.pred, casc.theta, casc.active)
    canvas = torch.zeros((4, 12, 12))
    with pytest.raises(ValueError, match="window"):
        tc.cascade_response_grid(canvas, casc, (4, 4))  # features past 4
    assert tc.cascade_response_grid(canvas, casc, (8, 8))[0].shape == (4, 4)


# (H, W) of the VGA canvas and of the config-5 4K canvas
CANVASES = [(1112, 512), (3960, 2048)]


def _decode_records(layout, rec, T, NN, shape):
    """The packed records of ``node_records`` back to tables: theta (bits
    as float32), counts, and per node fch, fr, fc, thr, left, right, pred
    (both children -1 at a leaf; HEAP2: the 7-node complete heaps)."""
    C, H, W = shape
    if layout == tc.HEAP2:
        r = rec.reshape(T, 12)
        off = r[:, 0:6:2].astype(np.int64)
        node = np.zeros((T, 7, 4), np.int32)
        node[:, :3, 0] = off
        node[:, :3, 1] = r[:, 1:6:2]
        node[:, :3, 2] = np.arange(1, 7, 2) | (np.arange(2, 8, 2) << 16)
        node[:, 3:, 2] = -1
        node[:, 3:, 3] = r[:, 8:]
        theta, counts = r[:, 6], r[:, 7]
    else:
        Tp = T + T % 2
        stage = rec[:2 * Tp].reshape(Tp, 2)[:T]
        node = rec[2 * Tp:].reshape(T, NN, 4)
        theta, counts = stage[:, 0], stage[:, 1]
    off, kids = node[..., 0].astype(np.int64), node[..., 2]
    leaf = kids < 0
    return {"theta": theta.view(np.float32), "counts": counts,
            "fch": off // (H * W), "fr": off % (H * W) // W, "fc": off % W,
            "thr": node[..., 1].view(np.float32),
            "left": np.where(leaf, -1, kids & 0xFFFF),
            "right": np.where(leaf, -1, kids >> 16),
            "pred": node[..., 3].view(np.float32)}


def _assert_records_decode(tab, theta, counts, records, shape, layout):
    """The records decode to ``tab`` (GENERAL: field for field, with each
    offset fch*H*W + fr*W + fc), or (HEAP2) to complete heaps whose every
    internal node's offset is fch*H*W + fr*W + fc and which give the same
    responses as ``tab`` on a random canvas of that shape."""
    assert records.layout == layout
    rec = records.data.numpy()
    T, NN = tab["fr"].shape
    assert rec.dtype == np.int32 and rec.nbytes % 16 == 0
    got = _decode_records(layout, rec, T, NN, shape)
    np.testing.assert_array_equal(got["theta"], np.asarray(theta, np.float32))
    np.testing.assert_array_equal(got["counts"], np.asarray(counts, np.int32))
    if layout == tc.GENERAL:
        assert rec.size == 2 * (T + T % 2) + 4 * T * NN
        inner = tab["left"] >= 0
        for f in ("fch", "fr", "fc", "thr", "pred", "left"):
            np.testing.assert_array_equal(got[f], tab[f], err_msg=f)
        np.testing.assert_array_equal(got["right"][inner], tab["right"][inner])
        return
    assert rec.size == 12 * T
    C, H, W = shape
    # the decoded heaps route like the tables: same hs on a random canvas
    rng = np.random.RandomState(0)
    m = int(max(tab["fr"].max(), got["fr"].max())) + 1
    n = int(max(tab["fc"].max(), got["fc"].max())) + 1
    canvas = torch.from_numpy(rng.randint(0, 8, (1, C, m + 3, n + 4))
                              .astype(np.float32))
    canvas[:, :, ::2] = torch.from_numpy(
        tab["thr"].reshape(-1)[rng.randint(0, tab["thr"].size,
                                           canvas[:, :, ::2].shape)])
    valid = torch.ones((3, 4), dtype=torch.uint8)
    want = tc.lockstep(canvas, valid, tab, [-np.inf] * T, T)[0]
    heap = {k: got[k] for k in tc.NODE_KEYS}
    np.testing.assert_array_equal(tc.lockstep(canvas, valid, heap,
                                              [-np.inf] * T, T)[0], want)


@pytest.mark.parametrize("hw", CANVASES)
@pytest.mark.parametrize("name", ["flagship_synth_64", "flagship_hard_256",
                                  "fpga_4k_synth_64"])
def test_node_records_decode_to_tables(name, hw):
    """The packed records of the frozen cascade (B3, B4, file node order)
    and of the padded runtime tables (B6, complete heaps) of the committed
    depth-2 models take the HEAP2 layout, 48 bytes a stage, and decode
    back to their tables."""
    m = wt.load(os.path.join(ROOT, "models", name + ".pb"), device="cpu")
    shape = (m.shape[2],) + hw
    ops = m._operands()
    sc = ops.sc
    _assert_records_decode(vars(sc), ops.theta, np.ones(sc.n_stages),
                           ops.records(shape), shape, tc.HEAP2)
    casc, _ = m._get_cascade()
    h = casc.host
    _assert_records_decode(h, h["theta"], h["active"], casc.records(shape),
                           shape, tc.HEAP2)
    # complete heaps decode field for field
    got = _decode_records(tc.HEAP2, casc.records(shape).data.numpy(),
                          casc.n_stages, 7, shape)
    for f in ("fch", "fr", "fc", "thr", "left", "right"):
        np.testing.assert_array_equal(got[f][:, :3], h[f][:, :3], err_msg=f)
    np.testing.assert_array_equal(got["pred"][:, 3:], h["pred"][:, 3:])
    assert casc.records(shape) is casc.records(shape)  # built once
    assert casc.records(shape).data.numel() * 4 == 48 * casc.n_stages


@pytest.mark.parametrize("n_stages", [3, 33])
def test_node_records_of_general_trees(n_stages):
    """Depth-5 trees (general node order, padded stages with inactive
    flags) take the GENERAL layout; B3/B4 records hold -inf for a
    non-finite theta, B6 records theta as the tables hold it."""
    _, tm = make_model_pair(n_stages=n_stages, seed=6, depth=5)
    shape = (4,) + CANVASES[0]
    ops = tm._operands()
    assert np.isneginf(ops.theta[~np.isfinite(ops.sc.theta)]).all()
    _assert_records_decode(vars(ops.sc), ops.theta, np.ones(n_stages),
                           ops.records(shape), shape, tc.GENERAL)
    casc, meta = tm._get_cascade()
    assert not meta.complete and casc.n_stages > n_stages
    h = casc.host
    _assert_records_decode(h, h["theta"], h["active"], casc.records(shape),
                           shape, tc.GENERAL)


@pytest.mark.parametrize("kind", ["stump", "mixed"])
def test_node_records_of_shallow_trees(kind):
    """Stumps and mixed depth-1/2 stages become complete depth-2 heaps with
    pass-through splits: the same responses."""
    stages = _stages(kind, 9, seed=4)
    tab = tc.stage_tables(stages)
    theta = np.linspace(-1, 0, 9).astype(np.float32)
    layout, rec = tc.node_records(tab, theta, np.ones(9), (4, 20, 24))
    _assert_records_decode(tab, theta, np.ones(9), tc.NodeRecords(
        layout, torch.from_numpy(rec)), (4, 20, 24), tc.HEAP2)


def test_node_records_checked():
    tab = tc.stage_tables(_stages("depth2", 2, seed=1))
    with pytest.raises(ValueError, match="int32"):
        tc.node_records(tab, [0.0, 0.0], [1, 1], (5, 40000, 20000))
    wide = {k: np.full((1, tc.MAX_RECORD_NODES + 1),
                       -1 if k in ("left", "right") else 0, v.dtype)
            for k, v in tab.items()}
    # a depth-3 path, so the tables keep the GENERAL layout
    wide["left"][0, :4], wide["right"][0, :4] = [1, 3, 5, 7], [2, 4, 6, 8]
    with pytest.raises(ValueError, match="nodes"):
        tc.node_records(wide, [0.0], [1], (4, 8, 8))
