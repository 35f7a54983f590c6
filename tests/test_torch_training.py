"""The port's training module (``waldboost_tpu_torch/training.py``) against
the JAX package's on the same numpy-seeded inputs, on the CPU.

Tolerances: ``weights``, ``loss``, the host SPRT threshold and the learner
statistics bitwise (both are the same float64 numpy code); the device SPRT
threshold bitwise against JAX's device version (float32 both); trees as in
``test_torch_fit.py`` (structure and quantile thresholds bitwise,
predictions within 1e-5).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waldboost_tpu as wb
from waldboost_tpu import training as jtr
from waldboost_tpu.fpga import training as jfpga

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import training as ttr

from test_threshold_device import CASES

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import tree_diff  # noqa: E402  (numpy only)

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_weights_and_loss_bitwise():
    rng = np.random.RandomState(0)
    for H in (rng.randn(1000).astype("f"), np.zeros(7, "f"),
              np.zeros(0, "f")):
        np.testing.assert_array_equal(ttr.weights(H), jtr.weights(H))
    H0, H1 = rng.randn(300).astype("f"), rng.randn(40).astype("f") + 1
    for a, b in ((H0, H1), (H0, H1[:0]), (H0[:0], H1)):
        assert ttr.loss(a, b) == jtr.loss(a, b)


DEGENERATE = [
    # non-overlapping -> min(H1)
    (np.array([-2., -1.]), np.array([1., 2.])),
    # fewer than 3 unique values -> -inf
    (np.array([0., 0.]), np.array([0., 0.])),
    # an empty class -> -inf
    (np.zeros(0), np.array([0., 1., 2.])),
]


@pytest.mark.parametrize("case", range(len(CASES) + len(DEGENERATE)))
@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.2])
def test_host_sprt_bitwise(case, alpha):
    H0, H1 = (CASES + DEGENERATE)[case]
    for P0, P1 in ((1.0, 1.0), (0.6, 0.4)):
        got = ttr.fit_rejection_threshold(H0, P0, H1, P1, alpha)
        want = jtr.fit_rejection_threshold(H0, P0, H1, P1, alpha)
        assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("padded", [False, True])
def test_device_sprt_matches_jax(case, padded):
    H0, H1 = (np.asarray(h, np.float32) for h in CASES[case])
    v0 = v1 = None
    if padded:
        v0 = np.arange(len(H0) + 9) < len(H0)
        v1 = np.arange(len(H1) + 3) < len(H1)
        H0 = np.concatenate([H0, np.full(9, -100.0, np.float32)])
        H1 = np.concatenate([H1, np.full(3, np.inf, np.float32)])
    want = float(jtr.fit_rejection_threshold_device(
        jnp.asarray(H0), jnp.asarray(H1), 0.55, 0.45, 0.2,
        v0=None if v0 is None else jnp.asarray(v0),
        v1=None if v1 is None else jnp.asarray(v1)))
    got = ttr.fit_rejection_threshold_device(
        torch.from_numpy(H0), torch.from_numpy(H1), 0.55, 0.45, 0.2,
        v0=None if v0 is None else torch.from_numpy(v0),
        v1=None if v1 is None else torch.from_numpy(v1))
    assert got.dtype == torch.float32
    assert float(got) == want


def test_rejection_schedule_matches_jax():
    for args in (dict(rejection_interval=(2, 5), target_p0=1e-5),
                 dict(rejection_interval=None), dict()):
        a, b = ttr.BasicRejectionSchedule(**args), \
            jtr.BasicRejectionSchedule(**args)
        for stage, p0 in ((0, 1.0), (3, 1.0), (6, 1.0), (3, 1e-6),
                          (100, 0.5)):
            assert a(stage, p0) == b(stage, p0)


def _pool(seed=0, n0=500, n1=300):
    rng = np.random.RandomState(seed)
    X0 = np.abs(rng.randn(n0, 4, 4, 2)).astype("f") * 50
    X1 = (np.abs(rng.randn(n1, 4, 4, 2)) * 50 + 15).astype("f")
    H0 = (rng.randn(n0) * 0.3).astype("f")
    H1 = (rng.randn(n1) * 0.3 + 0.2).astype("f")
    return X0, H0, X1, H1


class Forced:
    """Teacher forcing: a weak learner whose ``fit`` fits the port's tree
    (kept in ``fits``) and returns the JAX package's tree of that stage,
    so both learners go on from the same cascade."""

    def __init__(self, wh=ttr.DTree):
        self.wh, self.trees, self.fits = wh, [], []

    def fit(self, X0, W0, X1, W1, device=None, **kwargs):
        self.fits.append(self.wh.fit(X0, W0, X1, W1, device=device,
                                     **kwargs))
        return self.trees[len(self.fits) - 1]


def as_port_tree(jtree):
    s = jtree.to_stage_dict()
    return ttr.DTree(s["feature"], s["threshold"], s["left"], s["right"],
                     s["prediction"])


def assert_tree_close(tree, jtree):
    """Structure and thresholds bitwise, predictions within 1e-5."""
    diff = tree_diff(tree, jtree.to_stage_dict())
    assert diff is None, diff


def test_fit_stage_matches_jax(tmp_path):
    """Two stages of Learner.fit_stage on the same pools, teacher-forced:
    the port's trees against JAX's; model thetas (float32 in the port,
    float64 in JAX) and learner statistics bitwise; then save and load
    keep the statistics."""
    opts = dict(shrink=2, n_per_oct=2, smooth=0, channels="grad_hist")
    jm = wb.Model((4, 4, 2), opts)
    tm = wt.Model((4, 4, 2), opts, device="cpu")
    jl = jtr.Learner(alpha=0.2, max_depth=2)
    forced = Forced()
    tl = ttr.Learner(alpha=0.2, wh=forced, max_depth=2)
    for s in range(2):
        X0, H0, X1, H1 = _pool(seed=s)
        want = jl.fit_stage(jm, X0, H0, X1, H1)
        forced.trees.append(as_port_tree(jm.classifier[-1]))
        got = tl.fit_stage(tm, X0, H0, X1, H1)
        assert got == want
        assert_tree_close(forced.fits[-1], jm.classifier[-1])
        assert tm.theta[-1] == float(np.float32(jm.theta[-1]))
    assert tl.history == jl.history
    tl.wh = ttr.DTree
    path = str(tmp_path / "learner.pkl")
    tl.save(path)
    back = ttr.Learner.load(path)
    assert back.history == tl.history and back.wh is ttr.DTree
    assert back.wh_args == {"max_depth": 2} and back.alpha == 0.2
    np.testing.assert_array_equal(back.get_stats()["loss"],
                                  jl.get_stats()["loss"])


def test_dtree_host_inference_and_fields():
    X0, H0, X1, H1 = _pool(seed=3)
    W0, W1 = jtr.weights(H0), jtr.weights(-H1)
    jt = jtr.DTree.fit(X0, W0, X1, W1, max_depth=2)
    tt = ttr.DTree(*(jt.to_stage_dict()[k] for k in (
        "feature", "threshold", "left", "right", "prediction")))
    X = np.concatenate([X0, X1])
    np.testing.assert_array_equal(tt.apply(X), jt.apply(X))
    np.testing.assert_array_equal(tt.predict(X), jt.predict(X))
    img = np.abs(np.random.RandomState(1).randn(20, 30, 2)).astype("f") * 50
    rs, cs = np.indices((16, 26))
    rs, cs = rs.ravel(), cs.ravel()
    np.testing.assert_array_equal(tt.predict_on_image(img, rs, cs),
                                  jt.predict_on_image(img, rs, cs))
    from waldboost_tpu.proto import model_pb2
    pb = model_pb2.DTree()
    jt.as_proto(pb)
    msg = tt.as_proto()
    np.testing.assert_array_equal(msg["feature"], np.asarray(pb.feature))
    back = ttr.DTree.from_proto(msg)
    np.testing.assert_array_equal(back.predict(X), jt.predict(X))
    m = wt.Model((4, 4, 2), dict(shrink=2, n_per_oct=2, smooth=0,
                                 channels="grad_hist"), device="cpu")
    m.append(back, -0.5)
    np.testing.assert_array_equal(m.stages[0]["feature"],
                                  jt.to_stage_dict()["feature"])


def test_sklearn_backend_is_lazy():
    """The sklearn backend imports scikit-learn at the call only: without
    it the call raises ImportError, and nothing else needs it."""
    X0, H0, X1, H1 = _pool(seed=4, n0=60, n1=40)
    try:
        import sklearn  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            ttr.DTree.fit(X0, jtr.weights(H0), X1, jtr.weights(-H1),
                          backend="sklearn")
        return
    got = ttr.DTree.fit(X0, jtr.weights(H0), X1, jtr.weights(-H1),
                        backend="sklearn")
    want = jtr.DTree.fit(X0, jtr.weights(H0), X1, jtr.weights(-H1),
                         backend="sklearn")
    np.testing.assert_array_equal(got.feature, want.feature)
    np.testing.assert_array_equal(got.threshold, want.threshold)


_LOAD_WITHOUT_JAX = r"""
import builtins, sys
real_import = builtins.__import__
def guard(name, *args, **kwargs):
    if name == "jax" or name.startswith("jax.") or name == "waldboost_tpu" \
            or name.startswith("waldboost_tpu."):
        raise ImportError("blocked: " + name)
    return real_import(name, *args, **kwargs)
builtins.__import__ = guard
sys.path.insert(0, sys.argv[1])
import waldboost_tpu_torch as wt
from waldboost_tpu_torch.fpga import training as fpga_training
for path, wh in ((sys.argv[2], wt.DTree), (sys.argv[3], fpga_training.DTree)):
    L = wt.Learner.load(path)
    assert L.wh is wh, L.wh
    print(L.alpha, L.wh_args, L.p0, L.p1, L.losses)
assert not any(m == "jax" or m.startswith("waldboost_tpu.")
               for m in sys.modules), "jax was imported"
"""


def test_jax_learner_pickle_loads_without_jax(tmp_path):
    """A Learner pickled by the JAX package (its wh is
    ``waldboost_tpu.training.DTree``, or the FPGA one) loads in the port in
    a process where importing jax or waldboost_tpu raises."""
    paths = []
    for wh, name in ((jtr.DTree, "base"),
                     (jfpga.DTree, "fpga")):
        L = jtr.Learner(alpha=0.25, wh=wh, max_depth=3)
        L.record_stage(0.5, 0.99, 0.125)
        L.record_stage(0.25, 0.98, 0.0625)
        path = str(tmp_path / f"{name}.pkl")
        L.save(path)
        with open(path, "rb") as f:
            assert b"waldboost_tpu" in f.read()
        paths.append(path)
    out = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_JAX, ROOT,
                          *paths], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == ("0.25 {'max_depth': 3} [0.5, 0.25] [0.99, 0.98] "
                        "[0.125, 0.0625]")
    assert len(lines) == 2


def test_unknown_pickled_class_raises(tmp_path):
    """A JAX-package global with no counterpart in the port (the
    double-float helpers of ``ops/dd.py``) raises instead of importing
    the JAX package."""
    from waldboost_tpu.ops import dd
    d = dict(alpha=0.1, wh=dd.two_sum, wh_args={}, p0=[], p1=[], losses=[])
    path = tmp_path / "odd.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        ttr.Learner.load(str(path))
