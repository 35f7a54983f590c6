"""The port's sample mining (``waldboost_tpu_torch/samples.py``,
``mining.py``, ``Model.gather_windows_device``) against the JAX package's
on the same numpy-seeded inputs, on the CPU (plain versions of B1, B2, B5
and B6).

Tolerances: labels, instance ids, scores, boxes and the model's counters
bitwise; samples bitwise except values below 2**-30 in magnitude on both
sides, where JAX's XLA canvas and the port (as JAX's Pallas kernel) round
an exact cancellation differently (PARITY.md section 1c; the FPGA
channels are integers and bitwise throughout).
"""

import numpy as np
import pytest
import torch

import waldboost_tpu as wb
from waldboost_tpu import samples as jsamples
from waldboost_tpu.utils import fake_data_generator as jax_generator

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import samples as tsamples
from waldboost_tpu_torch.boxes import Boxes

torch.set_num_threads(4)

TINY = 2.0 ** -30


def assert_samples_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    differ = got != want
    assert not (differ & ((np.abs(got) >= TINY)
                          | (np.abs(want) >= TINY))).any()


def _boxes(rng, n, cls):
    xy = rng.uniform(0, 200, (n, 2)).astype("f")
    wh = rng.uniform(10, 60, (n, 2)).astype("f")
    return cls(np.concatenate([xy, xy + wh], axis=1))


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_label_boxes_matches_jax(seed, ignore):
    """Seeded draws (negatives first, then positives) pick the same
    windows; caps below the candidate counts force the draws."""
    rng = np.random.RandomState(seed)
    dt_rects = _boxes(rng, 400, Boxes).get()
    gt_rects = _boxes(rng, 5, Boxes).get()
    # detections near the ground truth, so there are TP candidates
    near = gt_rects[rng.randint(0, 5, 100)] + rng.uniform(-3, 3, (100, 4))
    dt_rects = np.concatenate([dt_rects, near.astype("f")])
    fields = dict(ignore=(np.arange(5) % 2).astype(np.int32)) \
        if ignore else {}
    out = {}
    for mod, cls in ((tsamples, Boxes), (jsamples, wb.Boxes)):
        dt = cls(dt_rects)
        mod.label_boxes(dt, cls(gt_rects, **fields), max_tp_candidates=7,
                        max_fp_candidates=30,
                        rng=np.random.default_rng(seed))
        out[mod] = dt
    for f in ("tp_label", "instance_id"):
        np.testing.assert_array_equal(out[tsamples].get_field(f),
                                      out[jsamples].get_field(f))
    # positives are drawn with replacement: at most 7 distinct
    assert 1 <= (out[tsamples].get_field("tp_label") == 1).sum() <= 7
    # a background image: every window is a negative candidate
    dt, jdt = Boxes(dt_rects), wb.Boxes(dt_rects)
    tsamples.label_boxes(dt, None, max_fp_candidates=30,
                         rng=np.random.default_rng(5))
    jsamples.label_boxes(jdt, None, max_fp_candidates=30,
                         rng=np.random.default_rng(5))
    np.testing.assert_array_equal(dt.get_field("tp_label"),
                                  jdt.get_field("tp_label"))


@pytest.mark.parametrize("channels", ["grad_hist", "grad_hist_4_u1"])
def test_pool_update_teacher_forced_matches_jax(channels):
    """SamplePool.update stage by stage with the same cascade in both
    packages (JAX's trees and thetas appended to both): pools and the
    model's counters equal after every update, up to the first update
    that mines through a cascade of trained stages (stage 3 for
    grad_hist)."""
    opts = dict(shrink=2, n_per_oct=2, smooth=1, channels=channels)
    jm = wb.Model((8, 8, 4), opts)
    tm = wt.Model((8, 8, 4), opts, device="cpu")
    jp = wb.SamplePool(min_tp=60, min_fp=60, seed=0)
    tp = wt.SamplePool(min_tp=60, min_fp=60, seed=0)
    jgen, tgen = jax_generator(seed=3), wt.utils.fake_data_generator(seed=3)
    learner = wb.Learner(alpha=0.2, max_depth=2)
    for stage in range(8):
        jp.update(jm, jgen)
        tp.update(tm, tgen)
        a, b = tp.samples, jp.samples
        assert len(a) == len(b)
        for f in ("tp_label", "instance_id", "scores", "row", "col"):
            np.testing.assert_array_equal(a.get_field(f), b.get_field(f),
                                          err_msg=f)
        np.testing.assert_array_equal(a.get(), b.get())
        assert_samples_equal(a.get_field("samples"), b.get_field("samples"))
        assert tp.pool_stats() == jp.pool_stats()
        assert tm.cost_stats()["n_weak"] == jm.cost_stats()["n_weak"]
        for k in ("n_loc", "n_images", "eval_cost", "worst_eval_cost"):
            assert tm.cost_stats()[k] == jm.cost_stats()[k], k
        if tm.cost_stats()["n_weak"] > 0:
            break
        X0, H0 = jp.get_false_positives()
        X1, H1 = jp.get_true_positives()
        learner.fit_stage(jm, X0, H0, X1, H1)
        tm.append(jm.classifier[-1].to_stage_dict(), jm.theta[-1])
    assert tm.cost_stats()["n_weak"] > 0


def test_gather_windows_device_matches_jax():
    """Model.gather_windows_device crops the same windows of a frame's
    canvas as JAX's (exact copies, up to the canvas tolerance), and they are
    the canvas's own windows at those origins, bitwise."""
    opts = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist")
    jm = wb.Model((8, 8, 4), opts)
    tm = wt.Model((8, 8, 4), opts, device="cpu")
    image = next(jax_generator(seed=4))["image"]
    canvas, packed, rs, cs, _ = tm.scan_packed(image)
    sel = np.random.RandomState(0).choice(rs.size, 50, replace=False)
    got = tm.gather_windows_device(image, rs[sel], cs[sel])
    want = jm.gather_windows_device(image, rs[sel], cs[sel])
    assert_samples_equal(got, want)
    cv = canvas.cpu().numpy()
    crops = np.stack([cv[:, r:r + 8, c:c + 8].transpose(1, 2, 0)
                      for r, c in zip(rs[sel], cs[sel])])
    assert got.shape == (50, 8, 8, 4)
    np.testing.assert_array_equal(got, crops)


def test_batched_records_and_candidates():
    recs = [dict(image=np.zeros(s, np.uint8), i=i) for i, s in enumerate(
        [(8, 8)] * 3 + [(9, 8)] * 4 + [(8, 8)])]
    got = [[r["i"] for r in g] for g in tsamples.batched_records(recs, 2)]
    want = [[r["i"] for r in g] for g in jsamples.batched_records(recs, 2)]
    assert got == want == [[0, 1], [2], [3, 4], [5, 6], [7]]
    cond = np.random.RandomState(0).rand(300) < 0.5
    for cap in (10, 1000):
        np.testing.assert_array_equal(
            tsamples.select_candidates(cond, cap, np.random.default_rng(1)),
            jsamples.select_candidates(cond, cap, np.random.default_rng(1)))
