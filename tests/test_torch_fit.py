"""The port's tree fit (``waldboost_tpu_torch/ops/fit.py``, ``DTree.fit``,
``fpga.DTree.fit``) against the JAX package's on the same numpy-seeded
inputs, on the CPU.

Tolerances: tree structure (feature, left, right) and quantile thresholds
(data values) bitwise; uniform thresholds within 1 ULP (XLA:CPU may fuse
``fmin + (b + 1) * width`` into an FMA); leaf predictions within 1e-5
(the leaf masses are summed in JAX's order, but ``log`` may differ by an
ULP).  The split masses are summed in another order than JAX's, which
could change a split only at a near tie.  JAX runs its CPU default
("einsum_f32") and its scatter path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from waldboost_tpu import training as jtr
from waldboost_tpu.fpga import training as jfpga
from waldboost_tpu.ops import fit as jfit

from waldboost_tpu_torch import training as ttr
from waldboost_tpu_torch.fpga import training as tfpga
from waldboost_tpu_torch.ops import fit as tfit
from waldboost_tpu_torch.testing import ulp_distance

torch.set_num_threads(4)


def _assert_trees(got, want, uniform=False):
    """Heap or pruned arrays ``(feature, threshold, left, right, pred)``."""
    names = ("feature", "threshold", "left", "right", "pred")
    got = [np.asarray(a) for a in got]
    want = [np.asarray(a) for a in want]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])
    if uniform:
        assert ulp_distance(got[1], want[1]).max() <= 1
    else:
        np.testing.assert_array_equal(got[1], want[1], err_msg="threshold")
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-5)


def _dtree_arrays(t):
    s = t.to_stage_dict()
    return (s["feature"], s["threshold"], s["left"], s["right"],
            s["prediction"])


def _data(n0, n1, shape, seed, dyadic=False):
    rng = np.random.RandomState(seed)
    X0 = rng.randn(n0, *shape).astype("f")
    X1 = (rng.randn(n1, *shape) + 0.4).astype("f")
    if dyadic:
        # weights k / 64: every partial sum is exact in float32
        W0 = (rng.randint(1, 8, n0) / 64.0).astype("f")
        W1 = (rng.randint(1, 8, n1) / 64.0).astype("f")
    else:
        W0 = rng.rand(n0).astype("f")
        W1 = rng.rand(n1).astype("f")
    return X0, W0, X1, W1


@pytest.mark.parametrize("hist_mode", ["einsum_f32", "scatter"])
@pytest.mark.parametrize("n", [255, 256, 257, 2048, 2049])
def test_dtree_fit_matches_jax_quantile(n, hist_mode, monkeypatch):
    """DTree.fit pads N to max(256, 2**k) as JAX does; the quantile edges'
    stride depends on that padded count."""
    monkeypatch.setattr(jfit, "hist_mode_from_env", lambda: hist_mode)
    X0, W0, X1, W1 = _data(n // 2, n - n // 2, (4, 4, 3), seed=n)
    want = jtr.DTree.fit(X0, W0, X1, W1, max_depth=2)
    got = ttr.DTree.fit(X0, W0, X1, W1, max_depth=2, device="cpu")
    _assert_trees(_dtree_arrays(got), _dtree_arrays(want))


@pytest.mark.parametrize("n", [255, 257, 2048])
def test_dtree_fit_matches_jax_uniform(n, monkeypatch):
    """Channel features are >= 0, so ``fmin + (b + 1) * width`` does not
    cancel: rounded once (an FMA) or twice, it is within 1 ULP.  (With a
    negative fmin, XLA:CPU's contraction drifts several ULP from the
    expression as written, which the port evaluates.)"""
    monkeypatch.setattr(jfit, "hist_mode_from_env", lambda: "einsum_f32")
    X0, W0, X1, W1 = _data(n // 2, n - n // 2, (4, 4, 3), seed=100 + n)
    X0, X1 = np.abs(X0), np.abs(X1)
    want = jtr.DTree.fit(X0, W0, X1, W1, max_depth=3, binning="uniform")
    got = ttr.DTree.fit(X0, W0, X1, W1, max_depth=3, binning="uniform",
                        device="cpu")
    _assert_trees(_dtree_arrays(got), _dtree_arrays(want), uniform=True)


def test_dtree_fit_matches_jax_stage0_shape():
    """Config 4's stage-0 shape: 8890 negatives and 1048 positives of
    (12, 12, 4) windows, padded to 16384 (JAX takes its scatter path
    there: the indicator would exceed its 2 GB rule)."""
    X0, W0, X1, W1 = _data(8890, 1048, (12, 12, 4), seed=9)
    X0 = np.abs(X0) * 40
    X1 = np.abs(X1) * 40
    want = jtr.DTree.fit(X0, W0, X1, W1, max_depth=2)
    got = ttr.DTree.fit(X0, W0, X1, W1, max_depth=2, device="cpu")
    _assert_trees(_dtree_arrays(got), _dtree_arrays(want))


@pytest.mark.parametrize("binning", ["quantile", "uniform"])
def test_fit_tree_complete_masks_and_padding(binning):
    """feature_mask, min_samples_leaf and padding rows in the middle of
    the input (held out by ``valid``), straight into fit_tree_complete."""
    rng = np.random.RandomState(4)
    N, F = 512, 20
    X = rng.randn(N, F).astype("f")
    y = (rng.rand(N) < 0.4).astype(np.int32)
    X[y == 1, 3] += 1.0
    X[y == 1, 7] += 0.8
    ws = rng.rand(N).astype("f")
    wp = rng.rand(N).astype("f")
    valid = rng.rand(N) < 0.8
    if binning == "uniform":
        X = np.abs(X)        # channel features are >= 0 (see above)
    X[~valid] = 1e6          # padding rows carry garbage
    fmask = np.ones((3, F), bool)
    fmask[0, 3] = False      # the best root feature is not allowed
    fmask[1, :10] = False
    want = jfit.fit_tree_complete(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(ws), jnp.asarray(wp),
        jnp.asarray(valid), max_depth=3, min_samples_leaf=40,
        feature_mask=jnp.asarray(fmask), binning=binning,
        hist_mode="einsum_f32")
    got = tfit.fit_tree_complete(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(ws),
        torch.from_numpy(wp), torch.from_numpy(valid), max_depth=3,
        min_samples_leaf=40, feature_mask=torch.from_numpy(fmask),
        binning=binning)
    assert int(np.asarray(want.feature)[0]) != 3
    assert (np.asarray(want.left) < 0).any()     # some early leaves
    _assert_trees(got, want, uniform=binning == "uniform")


def test_duplicate_features_dyadic_weights_identical():
    """Duplicated features tie exactly in both packages, and dyadic
    weights make every mass exact: the trees are identical (the first of
    equal gains wins in both)."""
    X0, W0, X1, W1 = _data(300, 212, (2, 2, 2), seed=5, dyadic=True)
    X0 = np.concatenate([X0, X0], axis=-1)
    X1 = np.concatenate([X1, X1], axis=-1)
    want = jtr.DTree.fit(X0, W0, X1, W1, max_depth=2)
    got = ttr.DTree.fit(X0, W0, X1, W1, max_depth=2, device="cpu")
    _assert_trees(_dtree_arrays(got), _dtree_arrays(want))
    assert all(f[2] < 2 for f, l in zip(got.feature, got.left) if l >= 0)


def test_prune_heap_tree_matches_jax():
    rng = np.random.RandomState(2)
    n = 15
    feature = rng.randint(0, 50, n).astype(np.int32)
    threshold = rng.randn(n).astype("f")
    pred = rng.randn(n).astype("f")
    left = np.full(n, -1, np.int32)
    right = np.full(n, -1, np.int32)
    for k in (0, 1, 2, 4, 6):     # inner nodes; 3 and 5 are early leaves
        left[k], right[k] = 2 * k + 1, 2 * k + 2
    want = jfit.prune_heap_tree(feature, threshold, left, right, pred)
    got = tfit.prune_heap_tree(feature, threshold, left, right, pred)
    assert len(got[0]) == 11
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_fpga_dtree_matches_jax():
    """Integer features (0-63, as the FPGA channels give): integer
    thresholds, leaves clipped to 3 and on the 1/32 grid, bank-restricted
    features per depth."""
    rng = np.random.RandomState(6)
    X0 = rng.randint(0, 40, (700, 8, 8, 4)).astype("f")
    X1 = rng.randint(10, 64, (300, 8, 8, 4)).astype("f")
    W0 = rng.rand(700).astype("f")
    W1 = rng.rand(300).astype("f")
    allowed = [np.arange(0, 256, 2), np.arange(1, 256, 2)]
    want = jfpga.DTree.fit(X0, W0, X1, W1, max_depth=2,
                           allowed_features=allowed)
    got = tfpga.DTree.fit(X0, W0, X1, W1, max_depth=2,
                          allowed_features=allowed, device="cpu")
    _assert_trees(_dtree_arrays(got), _dtree_arrays(want))
    assert np.array_equal(got.threshold, np.floor(got.threshold))
    assert np.abs(got.prediction).max() <= 3
    np.testing.assert_array_equal(got.prediction * 32,
                                  np.round(got.prediction * 32))


def test_full_f32_matmul_restores_setting():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with tfit.full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_full_f32_matmul_keeps_legacy_flag_usable():
    """The legacy ``torch.backends.cuda.matmul.allow_tf32`` switched around
    the context, as a caller's global TF32 setting is: each exit leaves
    every setting as it found it (the per-backend ones too), and after the
    caller's last switch torch still reads the precision.  A per-backend
    value left changed by the context once clashed with that switch, and
    torch refused to read the precision, in the fit too."""
    def state():
        return (torch.get_float32_matmul_precision(),
                [b.fp32_precision for b in tfit._matmul_backends()])

    start = state()
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            entered = state()
            with tfit.full_f32_matmul():
                assert torch.get_float32_matmul_precision() == "highest"
            assert state() == entered
        torch.backends.cuda.matmul.allow_tf32 = prev
        assert state()[0] == ("highest" if not prev else "high")
    finally:
        torch.set_float32_matmul_precision(start[0])
        for b, value in zip(tfit._matmul_backends(), start[1]):
            b.fp32_precision = value
        assert state() == start


def test_pixel_banks_match_jax():
    from waldboost_tpu.fpga import banks as jbanks
    from waldboost_tpu_torch.fpga import banks as tbanks
    for shape, block in (((8, 8, 4), (2, 2)), ((12, 12, 5), (2, 3)),
                         ((6, 10), (3, 1))):
        a, b = tbanks.PixelBanks(shape, block), jbanks.PixelBanks(shape, block)
        np.testing.assert_array_equal(a.pattern, b.pattern)
        sa, sb = tbanks.BankScheduler(a.n_banks), \
            jbanks.BankScheduler(b.n_banks)
        for _ in range(5):
            da, db = sa.schedule(2), sb.schedule(2)
            assert da == db
            np.testing.assert_array_equal(a.bank_pixels(da[0]),
                                          b.bank_pixels(db[0]))


def test_split_gains_f64_of_a_perfect_split():
    """chip_smoke.py's float64 gain report (printed when a card's split
    differs from the golden's): a feature that separates the classes
    exactly gains the whole bit of the balanced root entropy (less the
    fit's 1e-4 smoothing), and a depth-2 tree reports every inner node."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import split_gains_f64
    X0, W0, X1, W1 = _data(300, 200, (3, 2, 2), seed=8)
    X0[:, 1, 0, 1] = -5.0
    X1[:, 1, 0, 1] = 5.0
    tree = ttr.DTree.fit(X0, W0, X1, W1, max_depth=2, device="cpu")
    st = tree.to_stage_dict()
    assert tuple(st["feature"][0]) == (1, 0, 1)
    gains = split_gains_f64(X0, W0, X1, W1, st)
    assert set(gains) == {k for k in range(len(st["left"]))
                          if st["left"][k] >= 0}
    assert 0.99 < gains[0] <= 1.0
