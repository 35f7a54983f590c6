"""The port's training loops (``wt.train``, ``wt.fpga.train``), the
datasets, evaluation and the record prefetcher against the JAX package, on
the CPU.

Teacher forcing: the port's learner fits its own tree each stage (held to
JAX's: structure and quantile thresholds bitwise, predictions within
1e-5) but appends JAX's tree of that stage, so both runs go on from the
same cascade; then thetas (the port keeps them as float32), learner
statistics, pools and the model's counters are held bitwise.  Generators,
evaluation results and detections are bitwise.
"""

import itertools
import time

import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import testing as jtesting
from waldboost_tpu import utils as jutils
from waldboost_tpu.fpga import training as jfpga

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import io as tio
from waldboost_tpu_torch import testing as ttesting
from waldboost_tpu_torch import utils as tutils
from waldboost_tpu_torch.fpga import training as tfpga

from test_torch_training import Forced, as_port_tree, assert_tree_close
from torch_port_util import make_model_pair, sorted_rows

torch.set_num_threads(4)

OPTS = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist")


def _assert_runs_equal(jm, jl, jp, tm, tl, tp, fits):
    assert len(tm) == len(jm) == len(fits)
    for fit, weak in zip(fits, jm.classifier):
        assert_tree_close(fit, weak)
    assert tm.theta == [float(np.float32(t)) for t in jm.theta]
    assert tl.history == jl.history
    a, b = tp.samples, jp.samples
    for f in ("tp_label", "instance_id", "scores"):
        np.testing.assert_array_equal(a.get_field(f), b.get_field(f))
    for k in ("n_weak", "n_loc", "n_images", "eval_cost"):
        assert tm.cost_stats()[k] == jm.cost_stats()[k], k


def test_train_teacher_forced_matches_jax():
    length = 5
    jm = wb.Model((8, 8, 4), OPTS)
    jp = wb.SamplePool(min_tp=60, min_fp=60, seed=0)
    jl = wb.Learner(alpha=0.2, max_depth=2)
    wb.train(jm, jutils.fake_data_generator(seed=3), pool=jp, learner=jl,
             length=length)
    forced = Forced()
    forced.trees = [as_port_tree(w) for w in jm.classifier]
    tm = wt.Model((8, 8, 4), OPTS, device="cpu")
    tp = wt.SamplePool(min_tp=60, min_fp=60, seed=0)
    tl = wt.Learner(alpha=0.2, wh=forced, max_depth=2)
    wt.train(tm, tutils.fake_data_generator(seed=3), pool=tp, learner=tl,
             length=length)
    _assert_runs_equal(jm, jl, jp, tm, tl, tp, forced.fits)
    assert tm.cost_stats()["n_weak"] > 0


def test_fpga_train_teacher_forced_matches_jax(monkeypatch):
    """fpga.train at tests/test_fpga.py's settings, 3 stages: bank
    schedule, integer thresholds, clipped 1/32-grid leaves."""
    opts = dict(OPTS, channels="grad_hist_4_u1")
    jm = wb.Model((8, 8, 4), opts)
    jp = wb.SamplePool(min_tp=60, min_fp=60, seed=0)
    jl = jfpga.train(jm, jutils.fake_data_generator(seed=3), pool=jp,
                     length=3, max_depth=2)
    trees = [as_port_tree(w) for w in jm.classifier]
    fits = []

    def forced_fit(X0, W0, X1, W1, device=None, **kwargs):
        fits.append(wt.DTree.fit(X0, W0, X1, W1, backend="hist",
                                 integer_thresholds=True, device=device,
                                 **kwargs))
        return trees[len(fits) - 1]

    monkeypatch.setattr(tfpga.DTree, "fit", staticmethod(
        lambda X0, W0, X1, W1, max_depth=2, min_samples_leaf=10,
        allowed_features=None, clip=3, quantizer=32, n_bins=256,
        device=None: forced_fit(
            X0, W0, X1, W1, device=device, max_depth=max_depth,
            min_samples_leaf=min_samples_leaf,
            allowed_features=allowed_features, clip=clip,
            quantizer=quantizer, n_bins=n_bins)))
    tm = wt.Model((8, 8, 4), opts, device="cpu")
    tp = wt.SamplePool(min_tp=60, min_fp=60, seed=0)
    tl = wt.fpga.train(tm, tutils.fake_data_generator(seed=3), pool=tp,
                       length=3, max_depth=2)
    _assert_runs_equal(jm, jl, jp, tm, tl, tp, fits)
    for st in tm.stages:
        assert np.array_equal(st["threshold"], np.floor(st["threshold"]))
        np.testing.assert_array_equal(st["prediction"] * 32,
                                      np.round(st["prediction"] * 32))


def test_train_free_running_resume_and_jax_loads(tmp_path):
    """The verify workflow on the CPU: fpr falls stage by stage, SPRT
    rejection keeps eval_cost below the stage count, a resumed run (the
    learner saved and loaded) extends the model, and the JAX package
    loads the saved model and detects the same boxes."""
    gen = tutils.fake_data_generator(seed=7)
    model = wt.Model((12, 12, 4), dict(OPTS, n_per_oct=4), device="cpu")
    pool = wt.SamplePool(min_tp=200, min_fp=200, seed=0)
    learner = wt.train(model, gen, pool=pool, length=4,
                       learner=wt.Learner(alpha=0.2, max_depth=2))
    fpr = np.cumprod(learner.p0)
    assert len(model) == 4 and (np.diff(fpr) < 0).all()
    learner.save(str(tmp_path / "l.pkl"))
    model.save(str(tmp_path / "m.pb"))
    m2 = wt.load(str(tmp_path / "m.pb"), device="cpu")
    wt.train(m2, gen, pool=pool, learner=wt.Learner.load(
        str(tmp_path / "l.pkl")), length=6)
    assert len(m2) == 6
    frame = next(gen)["image"]
    m2.reset()
    boxes = m2.detect(frame)
    assert 0 < m2.eval_cost < len(m2)
    m2.save(str(tmp_path / "m2.pb"))
    jm = wb.load(str(tmp_path / "m2.pb"))
    jboxes = jm.detect(frame)
    np.testing.assert_array_equal(
        sorted_rows(boxes.get(), boxes.get_field("scores")),
        sorted_rows(jboxes.get(), jboxes.get_field("scores")))


def test_fpga_train_golden_on_cpu():
    """chip_smoke.py's phase 6v on the CPU: wt.fpga.train teacher-forced
    against the committed JAX golden (tests/data/
    torch_port_fpga_train_golden.npz, made by
    scripts/make_torch_train_golden.py): pools and counters bitwise,
    trees (structure and thresholds bitwise, predictions within 1e-5),
    thetas as float32, learner stats bitwise (loss within 1e-6)."""
    from chip_smoke import FPGA_TRAIN_GOLDEN, fpga_train_golden_run
    golden = np.load(FPGA_TRAIN_GOLDEN)
    model, _ = fpga_train_golden_run(wt, "cpu", golden)
    assert len(model) == len(golden["theta"]) == 2
    for s, st in enumerate(model.stages):
        np.testing.assert_array_equal(st["threshold"],
                                      golden[f"s{s}_threshold"])


@pytest.mark.parametrize("name", ["fake_data_generator", "scene_generator"])
def test_generators_bitwise(name):
    for seed in (0, 11):
        a = getattr(tutils, name)(seed=seed)
        b = getattr(jutils, name)(seed=seed)
        for ra, rb in itertools.islice(zip(a, b), 50):
            assert ra["image"].dtype == rb["image"].dtype == np.uint8
            np.testing.assert_array_equal(ra["image"], rb["image"])
            ga, gb = ra["groundtruth_boxes"], rb["groundtruth_boxes"]
            np.testing.assert_array_equal(ga.get(), gb.get())
            assert ga.field_names() == gb.field_names()
            for f in ga.field_names():
                np.testing.assert_array_equal(ga.get_field(f),
                                              gb.get_field(f))


def test_evaluator_matches_jax():
    """The same detections and ground truth (with ignore flags, boxes
    partly outside the frame) give the same curves and AUC, with and
    without aspect-ratio normalization."""
    rng = np.random.RandomState(3)
    ev_t, ev_j = ttesting.Evaluator(), jtesting.Evaluator()
    gen = tutils.scene_generator(seed=5)
    for i in range(12):
        gt = next(gen)["groundtruth_boxes"].get()
        dt = np.concatenate([gt + rng.uniform(-4, 4, gt.shape),
                             rng.uniform(0, 200, (20, 2)).repeat(2, 1)
                             + [0, 0, 30, 30]]).astype("f")
        scores = rng.randn(len(dt)).astype("f")
        ign = (rng.rand(len(gt)) < 0.3).astype(np.int32)
        for ev, mod in ((ev_t, wt), (ev_j, wb)):
            ev.add_ground_truth(i, mod.Boxes(gt, ignore=ign), (256, 256))
            ev.add_detections(i, mod.Boxes(dt, scores=scores))
    for kw in (dict(), dict(normalize_ar=1.0, match_iou_threshold=0.4),
               dict(min_gt_area=900, min_gt_area_in_image=0.8)):
        assert ev_t.evaluate(**kw) == ev_j.evaluate(**kw)


def test_evaluate_model_matches_jax():
    jm, tm = make_model_pair(n_stages=8, open_stages=2)
    recs = list(itertools.islice(jutils.fake_data_generator(seed=9), 6))
    got = ttesting.evaluate_model(recs, tm).evaluate()
    want = jtesting.evaluate_model(recs, jm).evaluate()
    assert got == want and len(got["precision"]) > 1
    a = np.random.RandomState(0).rand(40)
    b = a + np.float32(1e-7)
    np.testing.assert_array_equal(ttesting.ulp_distance(a, b),
                                  jtesting.ulp_distance(a, b))


def _prefetch_run(mod, depth=8, n_consumed=5, n_source=100, fail_at=None):
    """Drive ``mod``'s Prefetcher over a counting source until its producer
    is blocked (queue full plus one record in hand), then stop it:
    ``(consumed, residue, pulled, error)``.  With ``fail_at``, the source
    raises there and the consumer reads to the end."""
    pulled = []

    def gen():
        for i in range(n_source):
            if i == fail_at:
                raise ValueError(f"source fails at {i}")
            pulled.append(i)
            yield i

    pf = mod.Prefetcher(gen(), depth=depth)
    it = iter(pf)
    if fail_at is not None:
        consumed, error = [], None
        try:
            for item in it:
                consumed.append(item)
        except ValueError as e:
            error = str(e)
        return consumed, pf.stop(), pulled, error
    consumed = [next(it) for _ in range(n_consumed)]
    want = min(n_source, n_consumed + depth + 1)
    deadline = time.time() + 10
    while len(pulled) < want and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    return consumed, pf.stop(), pulled, None


def test_prefetcher_hands_back_records():
    """The port's Prefetcher and the JAX package's on the same source give
    the same records consumed, the same residue handed back (every record
    pulled and not consumed, in order, the one in flight included) and the
    same producer error at the consumer, at several depths and source
    lengths; prefetch_iterable keeps order."""
    from waldboost_tpu import io as jio
    for case in (dict(), dict(depth=1, n_consumed=0),
                 dict(depth=16, n_source=12), dict(fail_at=7)):
        got, want = _prefetch_run(tio, **case), _prefetch_run(jio, **case)
        assert got == want, case
        consumed, residue, pulled, _ = got
        assert consumed + residue == pulled, case
    for mod in (tio, jio):
        assert list(mod.prefetch_iterable(range(20), depth=3)) == list(
            range(20))


def test_train_hands_back_prefetched_records():
    """Two wt.train calls on one generator see every record once, in
    order: the records the first call's prefetcher pulled but did not use
    go to the second call."""
    base = tutils.fake_data_generator(seed=7)
    served, seen = [], []

    def gen():
        for i in itertools.count():
            rec = next(base)
            rec["idx"] = i
            served.append(i)
            yield rec

    g = gen()
    model = wt.Model((8, 8, 4), OPTS, device="cpu")
    pool = wt.SamplePool(min_tp=60, min_fp=60, seed=0)
    orig = pool._mine

    def spy(model_, iterable, need):
        def tap():
            for rec in iterable:
                seen.append(rec["idx"])
                yield rec
        yield from orig(model_, tap(), need)

    pool._mine = spy
    learner = wt.Learner(alpha=0.2, max_depth=2)
    wt.train(model, g, pool=pool, learner=learner, length=1, prefetch=4)
    banked = [r["idx"] for src, recs in wt._prefetch_residue.values()
              if src is g for r in recs]
    assert banked and seen + banked == served[:len(seen) + len(banked)]
    n_first = len(seen)
    wt.train(model, g, pool=pool, learner=learner, length=4, prefetch=4)
    assert len(seen) > n_first and seen == list(range(len(seen)))
    assert len(model) == 4


def test_train_softcascade_runs_on_cpu(monkeypatch):
    """The experimental constant-soft-cascade loop (sub-cascades of 2 and
    1 stages, no per-stage rejection while fitting, then the constant
    threshold), teacher-forced against wb.train_softcascade: each
    sub-cascade's trees, thetas and learner statistics, then the last
    pool (with the scores reset between sub-cascades) and the counters."""
    args = ((8, 8, 4), OPTS, [2, 1])

    def recorder(out):
        def cb(model, learner, stage):
            out.append((len(model), list(model.theta),
                        list(learner.history)))
        return cb

    jrecs, trecs, jtrees = [], [], []

    def keep_trees(model, learner, stage):
        jtrees.extend(model.classifier)

    jpool = wb.SamplePool(min_tp=40, min_fp=40, seed=0)
    jm = wb.train_softcascade(*args, jutils.fake_data_generator(seed=3),
                              callbacks=[recorder(jrecs), keep_trees],
                              casc_thr=-0.3, pool=jpool)
    trees = [as_port_tree(w) for w in jtrees]
    fits, plain_fit = [], wt.DTree.fit

    def forced_fit(X0, W0, X1, W1, device=None, **kwargs):
        fits.append(plain_fit(X0, W0, X1, W1, device=device, **kwargs))
        return trees[len(fits) - 1]

    monkeypatch.setattr(wt.DTree, "fit", staticmethod(forced_fit))
    tpool = wt.SamplePool(min_tp=40, min_fp=40, seed=0)
    tm = wt.train_softcascade(*args, tutils.fake_data_generator(seed=3),
                              callbacks=[recorder(trecs)], casc_thr=-0.3,
                              pool=tpool, device="cpu")
    assert len(trecs) == len(jrecs) == 2 and len(fits) == len(trees) == 3
    for fit, jtree in zip(fits, jtrees):
        assert_tree_close(fit, jtree)
    for (tn, ttheta, thist), (jn, jtheta, jhist) in zip(trecs, jrecs):
        assert tn == jn and jtheta == [-0.3] * jn
        assert ttheta == [float(np.float32(t)) for t in jtheta]
        assert thist == jhist
    assert len(tm) == len(jm) == 1
    a, b = tpool.samples, jpool.samples
    for f in ("tp_label", "instance_id", "scores"):
        np.testing.assert_array_equal(a.get_field(f), b.get_field(f))
    for k in ("n_weak", "n_loc", "n_images", "eval_cost"):
        assert tm.cost_stats()[k] == jm.cost_stats()[k], k


def test_groundtruth_matches_jax(tmp_path):
    from waldboost_tpu import groundtruth as jgt
    from waldboost_tpu_torch import groundtruth as tgt
    path = tmp_path / "a.txt"
    path.write_text("% bbGt version=3\n"
                    "car 10 20 30 40 0 0 0 0 0 0 0\n"
                    "car 5.5 6 7 8 0 0 0 0 0 1 0\n")
    for fmt in tgt.RectFormat:
        rects = np.arange(12, dtype="f").reshape(3, 4)
        a = tgt.bbox_list(rects, format=fmt)
        b = jgt.bbox_list(rects, format=jgt.RectFormat(int(fmt)))
        np.testing.assert_array_equal(a.get(), b.get())
    a, b = tgt.read_bbgt(str(path)), jgt.read_bbgt(str(path))
    np.testing.assert_array_equal(a.get(), b.get())
    for f in ("ignore", "labels"):
        np.testing.assert_array_equal(a.get_field(f), b.get_field(f))
