"""Two-phase and row-wise batched serving (JAX's serving options of
``make_batched_detector_boxes``) and their kernels' plain versions,
against the JAX package on the CPU.

Models: ``tests/test_model.py::make_model(n_stages=32)`` (JAX's own
two-phase tests; its near-constant responses give many tied scores) and a
random 32-stage cascade whose trees route both ways; 48x64 seeded noise
frames, a separate buffer for each package.  Tolerance 0: every one of
the five outputs (rects, scores, valid, count, n_weak) bitwise JAX's, in
JAX's slot order, overflow included; the suffix walk's plain version
bitwise JAX's ``cascade_suffix_sparse`` and the compaction's plain
version bitwise JAX's exact ``approx_max_k``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldboost_tpu.ops import cascade as jcasc
from waldboost_tpu.parallel import detect as jdet
from waldboost_tpu.parallel.mesh import make_mesh as jax_mesh

import waldboost_tpu_torch as wt
from waldboost_tpu_torch.ops import cascade as tcasc
from waldboost_tpu_torch.ops import nms as tnms
from waldboost_tpu_torch.parallel.detect import (RowwiseDetector,
                                                 TwoPhaseDetector,
                                                 detect_batch)
from waldboost_tpu_torch.parallel.mesh import gather, make_mesh

from test_model import make_model
from test_torch_fast import jax_fast
from torch_port_util import make_model_pair, noise_frames, port_canvas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

torch.set_num_threads(2)

HW = (48, 64)
OPTS = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist")


def _test_model_pair():
    jm = make_model(n_stages=32, shape=(8, 8, 4), opts=OPTS)
    tm = wt.model_from_stages(jm.shape, jm.channel_opts,
                              [w.to_stage_dict() for w in jm.classifier],
                              jm.theta, device="cpu")
    return jm, tm


_PAIRS = {}


def pair(name):
    """The JAX model and its port: ``test_model`` or ``random``."""
    if name not in _PAIRS:
        _PAIRS[name] = _test_model_pair() if name == "test_model" \
            else make_model_pair(n_stages=32, seed=6)
    return _PAIRS[name]


def run_both(jm, tm, images, jkw=None, **kw):
    """The five outputs of JAX's and the port's detectors built with the
    same keywords, each package fed its own copy of the frames."""
    fj, _ = jdet.make_batched_detector_boxes(jm, HW, **kw, **(jkw or {}))
    want = [np.asarray(a) for a in fj(jnp.asarray(images.copy()))]
    ft, _ = wt.make_batched_detector_boxes(tm, HW, device="cpu", **kw)
    got = [a.numpy() for a in ft(torch.from_numpy(images.copy()))]
    return got, want


def assert_bitwise(got, want):
    names = ("rects", "scores", "valid", "count", "n_weak")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# -- two-phase serving -------------------------------------------------------

@pytest.mark.parametrize("nms_iou", [None, 0.5])
@pytest.mark.parametrize("prefix,capacity,seed", [(8, 1024, 7),
                                                  (2, 16, 8),
                                                  (8, 64, 7)])
@pytest.mark.parametrize("model", ["test_model", "random"])
def test_two_phase_matches_jax(model, prefix, capacity, seed, nms_iou):
    """The complete setting (prefix 8, capacity 1024) and two overflowing
    ones (more prefix survivors than the capacity: the best of them, ties
    among them, walked to the end and flagged -1)."""
    jm, tm = pair(model)
    images = noise_frames(3, HW, seed=seed)
    got, want = run_both(jm, tm, images, k=512, two_phase=True,
                         prefix=prefix, capacity=capacity, nms_iou=nms_iou)
    assert_bitwise(got, want)
    assert ((got[3] == -1) == (capacity < 1024)).all()
    if capacity == 1024 or model == "test_model":
        assert got[2].any(axis=1).all()
    assert (got[4] > 0).all()


def test_two_phase_equals_dense_when_complete():
    """Rejection is monotone: where the prefix survivors fit, the
    two-phase detector keeps the dense detector's boxes, scores and n_weak
    (its n_weak counts only the walked windows, which are these)."""
    _, tm = pair("random")
    images = torch.from_numpy(noise_frames(3, HW, seed=11))
    tp, _ = wt.make_batched_detector_boxes(tm, HW, k=1024, device="cpu",
                                           two_phase=True)
    dense, _ = wt.make_batched_detector_boxes(tm, HW, k=1024, device="cpu")
    assert isinstance(tp, TwoPhaseDetector)
    a, b = tp(images), dense(images)
    assert torch.equal(a[3], b[3]) and (a[3] > 0).all()
    assert torch.equal(a[4], b[4])
    for i in range(3):
        assert torch.equal(a[0][i][a[2][i]], b[0][i][b[2][i]])
        assert torch.equal(a[1][i][a[2][i]], b[1][i][b[2][i]])


def test_two_phase_fast_matches_jax():
    """fast=True against JAX under WB_SERVING_MODE=fast with its Pallas
    channel kernel: the prefix and the suffix walk the bfloat16 canvas."""
    jm, tm = pair("random")
    images = noise_frames(2, HW, seed=12)
    for prefix, capacity in ((6, 1024), (2, 32)):
        kw = dict(k=512, two_phase=True, prefix=prefix, capacity=capacity,
                  nms_iou=0.5)
        with jax_fast():
            fj, _ = jdet.make_batched_detector_boxes(jm, HW, **kw)
            want = [np.asarray(a) for a in fj(jnp.asarray(images.copy()))]
        ft, _ = wt.make_batched_detector_boxes(tm, HW, device="cpu",
                                               fast=True, **kw)
        assert ft.prefix_step.canvas.fast
        got = [a.numpy() for a in ft(torch.from_numpy(images.copy()))]
        assert_bitwise(got, want)


def test_two_phase_fpga_matches_jax():
    """An FPGA model (grad_hist_4_u1+grad_mag_u1, C = 5, smooth 0), the
    canvas from the FPGA channels, complete and overflowing."""
    jm, tm = make_model_pair(n_stages=24, shape=(8, 8, 5), seed=4,
                             n_per_oct=2, smooth=0, thr_max=60.0,
                             channels="grad_hist_4_u1+grad_mag_u1")
    images = noise_frames(2, HW, seed=23)
    for prefix, capacity in ((12, 8192), (3, 24)):
        got, want = run_both(jm, tm, images, k=256, two_phase=True,
                             prefix=prefix, capacity=capacity)
        assert_bitwise(got, want)


def test_two_phase_mesh_matches_jax():
    """Two CPU shards against JAX's two-device CPU mesh and the unsharded
    port."""
    jm, tm = pair("random")
    images = noise_frames(4, HW, seed=13)
    kw = dict(k=512, two_phase=True, prefix=4, capacity=256, nms_iou=0.5)
    fj, _ = jdet.make_batched_detector_boxes(jm, HW, mesh=jax_mesh(2), **kw)
    want = [np.asarray(a) for a in fj(jnp.asarray(images.copy()))]
    mesh = make_mesh(devices=["cpu"] * 2)
    fs, _ = wt.make_batched_detector_boxes(tm, HW, mesh=mesh, **kw)
    assert len(fs.parts) == 2
    got = [gather(o, mesh).numpy() for o in fs(images.copy())]
    assert_bitwise(got, want)
    fu, _ = wt.make_batched_detector_boxes(tm, HW, device="cpu", **kw)
    assert_bitwise(got, [a.numpy() for a in fu(torch.from_numpy(images))])


# -- the row-wise extractor ----------------------------------------------------

@pytest.mark.parametrize("nms_iou", [None, 0.4])
@pytest.mark.parametrize("k_row", [64, 1])
@pytest.mark.parametrize("model", ["test_model", "random"])
def test_rowwise_matches_jax(model, k_row, nms_iou):
    """extractor="rowwise": each grid row's best k_row, then the best k;
    k_row=1 overflows (count -1, one box a row)."""
    jm, tm = pair(model)
    images = noise_frames(3, HW, seed=3)
    got, want = run_both(jm, tm, images, k=2048, k_row=k_row,
                         extractor="rowwise", nms_iou=nms_iou,
                         with_n_weak=False)
    assert_bitwise(got, want)
    assert ((got[3] == -1) == (k_row == 1)).all()
    assert (got[4] > 0).all()  # counted whatever with_n_weak says


def test_rowwise_extraction_matches_jax_on_tied_maps():
    """extract_detections_rowwise alone on seeded maps of quantized
    scores (many ties), k smaller and larger than the candidates."""
    from waldboost_tpu.ops.nms import extract_detections_rowwise as jrow
    rng = np.random.RandomState(0)
    gu, gv = 12, 40
    hs = (rng.randint(0, 6, (2, gu, gv)) * 0.25).astype(np.float32)
    alive = rng.rand(2, gu, gv) < 0.3
    level_id = np.where(rng.rand(gu, gv) < 0.9, rng.randint(0, 3, (gu, gv)),
                        -1).astype(np.int32)
    offsets = np.array([[0, 0], [2, 3], [5, 1]], np.int32)
    inv_scales = np.array([1.0, 1.5, 2.25], np.float32)
    for k_row, k in ((4, 16), (64, 1024), (1, 5)):
        for b in range(2):
            want = [np.asarray(a) for a in jrow(
                jnp.asarray(hs[b]), jnp.asarray(alive[b]),
                jnp.asarray(level_id), jnp.asarray(offsets),
                jnp.asarray(inv_scales), jnp.asarray([8, 8], jnp.int32),
                k_row=k_row, k=k)]
            got = tnms.extract_detections_rowwise(
                torch.from_numpy(hs[b:b + 1].copy()),
                torch.from_numpy(alive[b:b + 1].copy()),
                torch.from_numpy(level_id.astype(np.int64)),
                torch.from_numpy(offsets.astype(np.int64)),
                torch.from_numpy(inv_scales.copy()), (8, 8), k_row, k)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0].numpy(), w)


# -- the kernels' plain versions -----------------------------------------------

def _suffix_inputs(tm, images, S, seed):
    """A canvas of ``images``, and per image ``S`` seeded grid origins
    with seeded scores and alive flags."""
    packed, _, _ = tm._plan(HW)
    canvas = port_canvas(images, packed, smooth=tm.channel_opts["smooth"])
    m, n, _ = tm.shape
    gu, gv = canvas.shape[2] - m, canvas.shape[3] - n
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice(gu * gv, S, replace=False)
                    for _ in images]).astype(np.int64)
    scores = rng.randn(len(images), S).astype(np.float32)
    alive = rng.rand(len(images), S) < 0.8
    return canvas, idx, scores, alive


@pytest.mark.parametrize("kind", ["heap2", "general", "bf16"])
def test_suffix_plain_matches_jax(kind):
    """cascade_suffix_sparse_plain against JAX's cascade_suffix_sparse
    from stage 5: depth-2 trees (HEAP2 records), depth-5 trees (GENERAL
    records), and a bfloat16 canvas; over the runtime Cascade (n_weak on
    active stages) and over the frozen cascade's operands."""
    depth = 5 if kind == "general" else None
    jm, tm = make_model_pair(n_stages=12, seed=9, depth=depth)
    images = noise_frames(2, HW, seed=14)
    canvas, idx, scores, alive = _suffix_inputs(tm, images, 300, seed=15)
    if kind == "bf16":
        canvas = canvas.to(torch.bfloat16)
    casc, meta = tm._get_cascade()
    ops = tm._operands("cpu")
    layout, _ = tcasc.node_records(casc.host, casc.host["theta"],
                                   casc.host["active"],
                                   tuple(canvas.shape[1:]))
    assert layout == (tcasc.GENERAL if kind == "general" else tcasc.HEAP2)
    jc, jmeta = jm._get_cascade()
    start = 5
    for b in range(len(images)):
        cv = canvas[b].float().numpy() if kind != "bf16" else None
        jchns = jnp.asarray(cv) if cv is not None else \
            jnp.asarray(canvas[b].float().numpy()).astype(jnp.bfloat16)
        want = [np.asarray(a) for a in jcasc.cascade_suffix_sparse(
            jchns, jc, tm.shape[:2], jmeta, jnp.asarray(idx[b]),
            jnp.asarray(scores[b]), jnp.asarray(alive[b]), start)]
        for tables in (casc, ops):
            got = tcasc.cascade_suffix_sparse_plain(
                canvas[b], tables, tm.shape[:2], meta,
                torch.from_numpy(idx[b]), torch.from_numpy(scores[b]),
                torch.from_numpy(alive[b]), start)
            # the dispatching entry takes the plain version on the CPU
            again = tcasc.cascade_suffix_sparse(
                canvas[b], tables, tm.shape[:2], meta,
                torch.from_numpy(idx[b]), torch.from_numpy(scores[b]),
                torch.from_numpy(alive[b]), start)
            for g, a, w in zip(got, again, want):
                np.testing.assert_array_equal(g.numpy(), w)
                assert torch.equal(g, a)
        assert want[1].sum() < alive[b].sum() and want[2] > 0


def test_suffix_batched_and_content_hw():
    """A (B, ...) batch equals each image alone, and ``content_hw`` walks
    a canvas allocation wider than its content with the content's grid
    width, as JAX does."""
    jm, tm = make_model_pair(n_stages=10, seed=10)
    images = noise_frames(2, HW, seed=16)
    canvas, idx, scores, alive = _suffix_inputs(tm, images, 200, seed=17)
    ops = tm._operands("cpu")
    args = lambda *a: [torch.from_numpy(x) for x in a]
    H, A, N = tcasc.cascade_suffix_sparse(canvas, ops, tm.shape[:2], None,
                                          *args(idx, scores, alive), 3)
    assert N.shape == (2,)
    for b in range(2):
        h, a, n = tcasc.cascade_suffix_sparse(
            canvas[b], ops, tm.shape[:2], None,
            *args(idx[b], scores[b], alive[b]), 3)
        assert torch.equal(H[b], h) and torch.equal(A[b], a) and N[b] == n
    wide = torch.nn.functional.pad(canvas, (0, 24, 0, 8))
    C, Hc, Wc = canvas.shape[1:]
    got = tcasc.cascade_suffix_sparse(wide.contiguous(), ops, tm.shape[:2],
                                      None, *args(idx, scores, alive), 3,
                                      content_hw=(Hc, Wc))
    jc, jmeta = jm._get_cascade()
    want = [np.asarray(a) for a in jcasc.cascade_suffix_sparse(
        jnp.asarray(wide[0].numpy()), jc, tm.shape[:2], jmeta,
        jnp.asarray(idx[0]), jnp.asarray(scores[0]), jnp.asarray(alive[0]),
        3, content_hw=(Hc, Wc))]
    for g, w, u in zip(got, want, (H, A, N)):
        assert torch.equal(g, u)
        np.testing.assert_array_equal(g[0].numpy(), w)
    with pytest.raises(ValueError):
        tcasc.cascade_suffix_sparse(canvas, ops, tm.shape[:2], None,
                                    *args(idx, scores, alive), -1)
    with pytest.raises(ValueError):
        tcasc.cascade_suffix_sparse(canvas, ops, tm.shape[:2], None,
                                    *args(idx[:1], scores, alive), 3)


@pytest.mark.parametrize("cap", [5, 37, 64, 399, 400])
def test_compact_plain_matches_approx_max_k(cap):
    """compact_survivors_plain against jax.lax.approx_max_k(recall_target=
    1.0) on maps of tied quantized scores with 37 and 40 survivors: cap
    below, at and above the count (the -inf tail in index order).  At cap
    = the map's size (and at 1) XLA:CPU returns equal scores in another
    order than the lower index first (ROADMAP §C): there the scores are
    held bitwise and each score's indices as a set."""
    rng = np.random.RandomState(1)
    masked = np.full((2, 20, 20), -np.inf, np.float32)
    for b, n_alive in enumerate((37, 40)):
        at = rng.choice(400, n_alive, replace=False)
        masked[b].reshape(-1)[at] = rng.randint(0, 4, n_alive) * 0.5
    count = torch.from_numpy((masked > -np.inf).sum(axis=(1, 2))
                             .astype(np.int32))
    scores, idx = tnms.compact_survivors(torch.from_numpy(masked.copy()),
                                         count, cap)
    plain = tnms.compact_survivors_plain(torch.from_numpy(masked.copy()),
                                         count, cap)
    assert scores.shape == idx.shape == (2, cap) and idx.dtype == torch.int64
    assert torch.equal(scores, plain[0]) and torch.equal(idx, plain[1])
    for b in range(2):
        ws, wi = jax.lax.approx_max_k(jnp.asarray(masked[b].reshape(-1)),
                                      cap, recall_target=1.0)
        np.testing.assert_array_equal(scores[b].numpy(), np.asarray(ws))
        if cap < 400:
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(wi))
        else:
            pairs = lambda s, i: sorted(zip(np.asarray(s).tolist(),
                                            np.asarray(i).tolist()))
            assert pairs(scores[b], idx[b]) == pairs(ws, wi)
    one = tnms.compact_survivors(torch.from_numpy(masked[0].reshape(-1)),
                                 count[0], cap)
    assert torch.equal(one[0], scores[0]) and torch.equal(one[1], idx[0])
    with pytest.raises(ValueError):
        tnms.compact_survivors(torch.from_numpy(masked.copy()), count, 401)


# -- entry points --------------------------------------------------------------

def test_vga_golden_on_cpu():
    """The committed JAX outputs of the flagship on six VGA frames
    (scripts/make_torch_twophase_golden.py: two-phase at JAX's defaults
    and overflowing, row-wise with NMS 0.5), every output whole, bitwise;
    ``chip_smoke.py`` phase 9a holds the card to the same file."""
    from chip_smoke import TWOPHASE_GOLDEN, twophase_golden_run
    model = wt.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"),
                    device="cpu")
    diffs, outs = twophase_golden_run(wt, torch.device("cpu"),
                                      np.load(TWOPHASE_GOLDEN), model)
    assert not any(diffs.values()), diffs
    assert (outs["tpo"][3] == -1).all() and (outs["tp"][3] >= 0).all()


def test_detect_batch_overflow_fallback_equals_detect():
    """detect_batch(k=16, k_row=1): every image overflows k and falls back
    to Model.detect (tests/test_parallel.py's contract)."""
    _, tm = pair("test_model")
    images = noise_frames(2, HW, seed=5)
    out = detect_batch(tm, images, k=16, k_row=1)
    for b, img in zip(out, images):
        single = tm.detect(img)
        assert len(b) == len(single) > 16
        np.testing.assert_array_equal(b.get(), single.get())
        np.testing.assert_array_equal(b.get_field("scores"),
                                      single.get_field("scores"))


def test_serving_options_dispatch_and_check():
    """JAX's dispatch (True: two-phase; "auto", False: dense; an extractor
    other than "approx": row-wise) and the values JAX checks."""
    _, tm = pair("random")
    build = lambda **kw: wt.make_batched_detector_boxes(tm, HW, device="cpu",
                                                        **kw)[0]
    assert isinstance(build(two_phase=True), TwoPhaseDetector)
    for tp in ("auto", False):
        assert isinstance(build(two_phase=tp), wt.parallel.detect.
                          BatchedDetector)
    assert isinstance(build(extractor="rowwise"), RowwiseDetector)
    assert isinstance(build(extractor="rowwise", two_phase=True),
                      TwoPhaseDetector)
    tp = build(two_phase=True, capacity=10 ** 9, k=10 ** 9)
    gu, gv = tp.grid.valid.shape
    assert tp.cap == tp.k_out == gu * gv
    assert (wt.parallel.detect.TWO_PHASE_BATCH_PREFIX,
            wt.parallel.detect.TWO_PHASE_BATCH_CAPACITY) == (12, 8192)
    assert (wt.model.TWO_PHASE_PREFIX, wt.model.TWO_PHASE_CAPACITY) == \
        (12, 4096)
    for bad in (dict(two_phase="yes"), dict(extractor="rowwise", n_scales=1),
                dict(extractor="rowwise", k_row=0),
                dict(two_phase=True, capacity=0),
                dict(two_phase=True, prefix=-1)):
        with pytest.raises(ValueError):
            build(**bad)
