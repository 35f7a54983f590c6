"""The port's device-pool trainer (``waldboost_tpu_torch/parallel/
train_step.py``, ``parallel/trainer.py``) against the JAX package's on the
same numpy-seeded inputs, on the CPU.

Tolerances: pool slots, samples, scores and validity bitwise; trees as in
``test_torch_fit.py`` (structure and quantile thresholds bitwise,
predictions within 1e-5).  Teacher forcing: the port's step fits its own
tree (held to JAX's) and then goes on with JAX's heap tree, so scores,
validity, theta, p0, p1 and the counts are held bitwise and the loss
(torch's ``exp`` and sum order against XLA's) within 1e-6.
"""

import contextlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu.parallel import train_step as jts
from waldboost_tpu.parallel import trainer as jtrainer
from waldboost_tpu.utils import fake_data_generator as jgen

import waldboost_tpu_torch as wt
from waldboost_tpu_torch.ops.fit import TreeFitResult
from waldboost_tpu_torch.parallel import DevicePool, make_train_step
from waldboost_tpu_torch.parallel import train_step as tts
from waldboost_tpu_torch.parallel.mesh import make_mesh
from waldboost_tpu_torch.parallel import trainer as ttrainer
from waldboost_tpu_torch.parallel.train_step import tree_predict_device
from waldboost_tpu_torch.utils import fake_data_generator as tgen

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (DEVICE_FPGA_TRAIN_GOLDEN,  # noqa: E402  (numpy only)
                        DEVICE_TRAIN_GOLDEN, device_train_golden_run)

torch.set_num_threads(4)

CPU = torch.device("cpu")
OPTS = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist")


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _assert_pools_equal(jpool, tpool, mined=False):
    """Slots, validity, scores and samples bitwise; ``mined`` samples up to
    values below 2**-30 on both sides (the exact-cancellation lines of JAX's
    XLA canvas, PARITY.md section 1c)."""
    assert jpool.capacity == tpool.capacity and jpool.count == tpool.count
    for k in ("v", "H"):
        np.testing.assert_array_equal(_np(getattr(jpool, k)),
                                      _np(getattr(tpool, k)), err_msg=k)
    jx, tx = _np(jpool.x), _np(tpool.x)
    if mined:
        tiny = (np.abs(jx) < 2.0 ** -30) & (np.abs(tx) < 2.0 ** -30)
        jx, tx = np.where(tiny, 0, jx), np.where(tiny, 0, tx)
    np.testing.assert_array_equal(jx, tx, err_msg="x")


def _assert_heap_close(got, want):
    """Heap tables: features, children and thresholds bitwise,
    predictions within 1e-5."""
    for k in ("feature", "left", "right", "threshold"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      _np(getattr(want, k)), err_msg=k)
    np.testing.assert_allclose(_np(got.pred), _np(want.pred), rtol=0,
                               atol=1e-5)


@contextlib.contextmanager
def forced_fits(trees, check=True):
    """Teacher forcing inside the port's step: each fit is held to the
    next of JAX's heap ``trees`` (with ``check``; the trees are taken
    after the step's FPGA transforms) and JAX's tree is used in its
    place."""
    real = tts.fit_tree_complete
    used = []

    def fit(*args, **kwargs):
        got = real(*args, **kwargs)
        want = TreeFitResult(*trees[len(used)])
        if check:
            _assert_heap_close(got, want)
        used.append(got)
        return TreeFitResult(*(torch.from_numpy(np.array(a))
                               for a in want))

    tts.fit_tree_complete = fit
    try:
        yield used
    finally:
        tts.fit_tree_complete = real


def _seeded_pools(seed, N=512, F=48, holes=True):
    """Two padded classes with invalid rows interleaved (every third row
    and a tail), scores in [-1, 1)."""
    rng = np.random.RandomState(seed)
    x0 = np.abs(rng.randn(N, F) * 20).astype("f")
    x1 = np.abs(rng.randn(N, F) * 20 + 4).astype("f")
    H0 = rng.uniform(-1, 1, N).astype("f")
    H1 = rng.uniform(-1, 1, N).astype("f")
    v0 = np.ones(N, bool)
    v1 = np.ones(N, bool)
    if holes:
        v0[::3] = False
        v0[-40:] = False
        v1[1::3] = False
        v1[-70:] = False
    return x0, H0, v0, x1, H1, v1


@pytest.mark.parametrize("capacity,n_seed", [(256, 40), (300, 0),
                                             (256, 250)])
def test_device_pool_insert_matches_jax(capacity, n_seed):
    """``insert`` and ``insert_from_device`` fill the same slots with the
    same bits as JAX's DevicePool (also after a stage left holes, and past
    the capacity)."""
    rng = np.random.RandomState(7)
    F = 24
    src = rng.randn(300, 2, 3, 4).astype(np.float32)  # crop-shaped rows
    sH = rng.randn(300).astype(np.float32)
    seed_x = rng.randn(n_seed, F).astype(np.float32)
    seed_H = rng.randn(n_seed).astype(np.float32)
    idx = np.flatnonzero(sH > 0.3)                    # a ragged subset

    ja, jb = jtrainer.DevicePool(capacity, F), jtrainer.DevicePool(capacity,
                                                                  F)
    ta, tb = DevicePool(capacity, F, device=CPU), DevicePool(capacity, F,
                                                            device=CPU)
    for p in (ja, jb, ta, tb):
        assert p.insert(seed_x, seed_H) == min(n_seed, p.capacity)
    ja.insert(src.reshape(300, -1)[idx], sH[idx])
    ta.insert(src.reshape(300, -1)[idx], sH[idx])
    jb.insert_from_device(jnp.asarray(src), jnp.asarray(sH), idx)
    tb.insert_from_device(torch.from_numpy(src), torch.from_numpy(sH), idx)
    for jp, tp in ((ja, ta), (jb, tb), (ja, tb)):
        _assert_pools_equal(jp, tp)

    # a stage prunes every other valid sample; the refill takes the holes
    keep = np.asarray(ja.v).copy()
    keep[np.flatnonzero(keep)[::2]] = False
    Hs = np.asarray(ja.H) + 1
    # each side gets its own buffers: on the CPU ``jnp.asarray`` keeps an
    # aligned numpy array without copying it, JAX's inserts run
    # asynchronously, and the torch pool writes ``H`` and ``v`` in place
    ja.apply_stage(jnp.array(Hs, copy=True), jnp.array(keep, copy=True))
    tb.apply_stage(torch.from_numpy(Hs.copy()), torch.from_numpy(keep.copy()),
                   int(keep.sum()))
    assert ja.count == tb.count == int(keep.sum())
    jb.insert_from_device(jnp.asarray(src), jnp.asarray(sH), idx[::-1])
    ja.insert_from_device(jnp.asarray(src), jnp.asarray(sH), idx[::-1])
    tb.insert_from_device(torch.from_numpy(src), torch.from_numpy(sH),
                          idx[::-1])
    _assert_pools_equal(ja, tb)


def _jax_step(kw, pools, P0, P1, theta_in, use_sprt, fmask):
    step = jts.make_train_step(**kw)
    return step(*(jnp.asarray(a) for a in pools), np.float32(P0),
                np.float32(P1), np.float32(theta_in), np.bool_(use_sprt),
                jnp.asarray(fmask))


@pytest.mark.parametrize("case", ["sprt", "theta_in", "fpga_mask"])
def test_train_step_matches_jax(case):
    """One stage step on seeded padded pools: the tree (free) against
    JAX's; then, with JAX's tree forced, H, v, theta, p0, p1, n0 and n1
    bitwise, the loss within 1e-6."""
    pools = _seeded_pools(seed={"sprt": 1, "theta_in": 2,
                                "fpga_mask": 3}[case])
    F = pools[0].shape[1]
    kw = dict(alpha=0.2, max_depth=2, n_bins=64)
    P0, P1, theta_in, use_sprt = 0.25, 0.875, -np.inf, True
    fmask = np.ones((2, F), bool)
    if case == "theta_in":
        theta_in, use_sprt = -0.25, False
    if case == "fpga_mask":
        kw.update(clip=3, quantizer=32, integer_thresholds=True)
        fmask = np.random.RandomState(5).rand(2, F) < 0.4
    want = _jax_step(kw, pools, P0, P1, theta_in, use_sprt, fmask)
    jtree = tuple(np.asarray(a) for a in want.tree)

    step = make_train_step(**kw)
    args = [torch.from_numpy(a) for a in pools] + [
        P0, P1, theta_in, use_sprt, torch.from_numpy(fmask)]
    free = step(*args)
    _assert_heap_close(free.tree, want.tree)
    with forced_fits([jtree], check=False):   # checked free above
        got = step(*args)
    for k in ("H0", "H1", "v0", "v1", "theta", "p0", "p1", "n0", "n1"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.theta.dtype == torch.float32 and got.n0.dtype == torch.int32
    np.testing.assert_allclose(_np(got.loss), np.asarray(want.loss),
                               rtol=1e-6)
    if case == "fpga_mask":
        thr, pred = _np(got.tree.threshold), _np(got.tree.pred)
        assert np.array_equal(thr, np.floor(thr))
        assert np.array_equal(pred * 32, np.round(pred * 32))
        assert np.abs(pred).max() <= 3
        feat = _np(got.tree.feature)
        for k in range(3):   # depth 0 is node 0, depth 1 nodes 1, 2
            if feat[k] >= 0:
                assert fmask[0 if k == 0 else 1, feat[k]]


def test_tree_predict_device_matches_jax():
    rng = np.random.RandomState(9)
    xf = rng.randn(400, 30).astype("f")
    for depth in (1, 2, 3):
        n = 2 ** (depth + 1) - 1
        inner = 2 ** depth - 1
        feature = rng.randint(0, 30, n).astype(np.int32)
        feature[inner:] = -1
        feature[rng.rand(n) < 0.2] = -1      # early leaves
        tree = (feature, rng.randn(n).astype("f"),
                np.full(n, -1, np.int32), np.full(n, -1, np.int32),
                rng.randn(n).astype("f"))
        want = jts.tree_predict_device(
            jts.TreeFitResult(*(jnp.asarray(a) for a in tree)),
            jnp.asarray(xf), depth)
        got = tree_predict_device(
            TreeFitResult(*(torch.from_numpy(a) for a in tree)),
            torch.from_numpy(xf), depth)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_sharded_matches_jax():
    """``train_sharded`` against JAX's at test_parallel.py::
    test_train_sharded_pools_carry_over's size, teacher-forced: 2 stages,
    2 more carried over (the same pool objects), then, after the model is
    grown from outside, 2 more from re-bootstrapped pools; after each call
    the models, thetas, learner statistics, pools and counters are
    equal (losses within 1e-6, samples up to values below 2**-30)."""
    trees = []
    real_make = jtrainer.make_train_step

    def recording(**kwargs):
        step = real_make(**kwargs)

        def rec(*args):
            res = step(*args)
            trees.append(tuple(np.asarray(a) for a in res.tree))
            return res
        return rec

    runs = {}
    for name, pkg, gen in (("jax", wb, jgen), ("port", wt, tgen)):
        kw = {} if pkg is wb else dict(device="cpu")
        runs[name] = (pkg.Model((12, 12, 4), OPTS, **kw),
                      pkg.Learner(alpha=0.2, max_depth=2), {}, gen(seed=29))
    (jm, jl, jpools, jg), (tm, tl, tpools, tg) = runs["jax"], runs["port"]
    n_used = 0
    jtrainer.make_train_step = recording
    try:
        for length in (2, 4, 6):
            if length == 6:
                # grown from outside: stage 0 again, no rejection
                w0 = jm[0][0]
                jm.append(wb.DTree(w0.feature, w0.threshold, w0.left,
                                   w0.right, w0.prediction), -np.inf)
                tm.append(tm[0][0], -np.inf)
                for lr in (jl, tl):
                    lr.record_stage(1.0, 1.0, lr.loss)
            jtrainer.train_sharded(jm, jg, mesh=None, learner=jl,
                                   length=length, min_tp=100, min_fp=100,
                                   seed=1, pools=jpools)
            before = (tpools.get("fp"), tpools.get("tp"), len(tm))
            with forced_fits(trees[n_used:]) as used:
                ttrainer.train_sharded(tm, tg, learner=tl, length=length,
                                       min_tp=100, min_fp=100, seed=1,
                                       pools=tpools)
            n_used += len(used)
            assert len(used) == length - before[2] > 0
            carried = tpools["fp"] is before[0] and tpools["tp"] is before[1]
            assert carried == (length == 4)
            assert len(tm) == len(jm) == length and n_used == len(trees)
            for (js, jt), (ts, tt) in zip(jm, tm):
                want = js.to_stage_dict()
                for k in want:
                    np.testing.assert_array_equal(ts[k], want[k])
                assert tt == jt
            assert [r[:2] for r in tl.history] == [r[:2] for r in jl.history]
            np.testing.assert_allclose(tl.losses, jl.losses, rtol=1e-6)
            for k in ("fp", "tp"):
                _assert_pools_equal(jpools[k], tpools[k], mined=True)
            for k in ("n_weak", "n_loc", "n_images"):
                assert tm.cost_stats()[k] == jm.cost_stats()[k], k
    finally:
        jtrainer.make_train_step = real_make


def test_device_train_golden_on_cpu():
    """Config 4b's 6 golden stages replayed on the CPU (chip_smoke.py's
    phase 6w check)."""
    model, _ = device_train_golden_run(wt, CPU, np.load(DEVICE_TRAIN_GOLDEN))
    assert len(model) == 6


def test_device_fpga_train_golden_on_cpu():
    """The FPGA options in-step (bank masks, clip, quantizer, integer
    thresholds): 2 golden stages replayed on the CPU, the fit held to
    JAX's tree before the transforms and the step's tree after them
    (chip_smoke.py's phase 6w check)."""
    model, _ = device_train_golden_run(
        wt, CPU, np.load(DEVICE_FPGA_TRAIN_GOLDEN), fpga=True)
    assert len(model) == 2


def test_sharded_options_raise():
    model = wt.Model((8, 8, 4), OPTS, device="cpu")
    # a mesh whose size does not divide the pools' slots or the samples
    mesh = make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh size"):
        make_train_step(mesh=mesh)(*(torch.zeros(256, 4) for _ in range(6)),
                                   0.5, 0.5, 0.0, False)
    with pytest.raises(ValueError, match="mesh size"):
        DevicePool(300, 16, mesh=mesh)
    pool = DevicePool(300, 16, mesh=make_mesh(devices=["cpu"] * 2))
    assert pool.capacity == 512 and [len(s) for s in pool.x] == [256] * 2
    # prewarm_length is accepted; a model already long enough returns at
    # once with the learner it was given
    learner = wt.Learner()
    assert ttrainer.train_sharded(model, iter(()), learner=learner,
                                  length=0, prewarm_length=8) is learner
