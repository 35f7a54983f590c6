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
