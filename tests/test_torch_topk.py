"""The exact top-k of every extraction (``ops/nms.py::topk_masked``,
kernel S2's plain version on the CPU), ``extract_detections`` and the
completeness check, against the JAX package on the CPU.

Maps: ``chip_smoke.topk_maps`` (numpy ``default_rng`` seeds), 6 rows of
400 entries (a 20 x 20 grid): heavy ties, all -inf, all finite, counts
k - 1, k, k + 1 and far above k, in both input forms (a masked map; hs
with an alive mask).  Tolerance 0: scores bitwise and indices equal to
``jax.lax.top_k`` always, and to ``jax.lax.approx_max_k(recall_target=
1.0)`` except at k = 1 and k = the map's size, where XLA:CPU returns
tied entries in another order (ROADMAP §C): there the scores are held
bitwise and the indices as a set (k = N) or as an entry of the same
score (k = 1).  Where a given survivor count differs from the map's,
the count is -1 and the batch incomplete, as in JAX (it used to raise).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldboost_tpu.ops import nms as jnms

from waldboost_tpu_torch.ops import nms as tnms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import topk_maps  # noqa: E402

torch.set_num_threads(2)

B, GU, GV = 6, 20, 20
N = GU * GV
KINDS = ("ties", "all_inf", "all_finite", "around_k", "far_above")
KS = (1, 2, 37, 64, 399, N)


def maps(kind, k, seed=3):
    """``(hs, alive, masked)`` numpy arrays of ``kind`` for a top ``k``."""
    hs, alive = topk_maps(kind, B, N, k, seed)
    return hs, alive, np.where(alive, hs, -np.inf).astype(np.float32)


def port_topk(hs, alive, masked, k, form):
    if form == "masked":
        return tnms.topk_masked(torch.from_numpy(masked.copy()), k)
    return tnms.topk_masked(torch.from_numpy(hs.copy()), k,
                            alive=torch.from_numpy(alive.copy()))


def reference(masked, k):
    """The contract in numpy: finite entries by score descending (-0 as
    +0), then index ascending; then the others by index."""
    key = np.where(np.isfinite(masked), masked + np.float32(0), -np.inf)
    order = np.stack([np.lexsort((np.arange(N), -row))[:k] for row in key])
    return np.take_along_axis(masked, order, 1), order


@pytest.mark.parametrize("form", ["masked", "hs"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_topk_matches_jax(kind, k, form):
    """topk_masked's plain version against lax.top_k and the exact
    approx_max_k of two-phase serving, row by row."""
    hs, alive, masked = maps(kind, k)
    scores, idx, present = port_topk(hs, alive, masked, k, form)
    assert scores.shape == idx.shape == (B, k)
    assert idx.dtype == torch.int64 and present.dtype == torch.int32
    np.testing.assert_array_equal(present.numpy(),
                                  np.isfinite(masked).sum(axis=1))
    for b in range(B):
        row = jnp.asarray(masked[b])
        ts, ti = jax.lax.top_k(row, k)
        np.testing.assert_array_equal(scores[b].numpy(), np.asarray(ts))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ti))
        ws, wi = (np.asarray(a) for a in
                  jax.lax.approx_max_k(row, k, recall_target=1.0))
        np.testing.assert_array_equal(scores[b].numpy(), ws)
        if 1 < k < N:
            np.testing.assert_array_equal(idx[b].numpy(), wi)
        elif k == N:
            assert sorted(zip(ws.tolist(), wi.tolist())) == sorted(
                zip(scores[b].tolist(), idx[b].tolist()))
        else:
            assert masked[b, wi[0]] == ws[0] or not np.isfinite(ws[0])


@pytest.mark.parametrize("k", [1, 5, 200, N])
def test_topk_signed_zeros_and_non_finite(k):
    """+0 and -0 tie (index order) and NaN, +inf and -inf entries rank as
    -inf, by index, in both forms; the scores are the map's values."""
    hs, alive, masked = maps("signed_zeros_nonfinite", k, seed=5)
    want_s, want_i = reference(masked, k)
    for form in ("masked", "hs"):
        scores, idx, present = port_topk(hs, alive, masked, k, form)
        np.testing.assert_array_equal(idx.numpy(), want_i)
        np.testing.assert_array_equal(scores.numpy().view(np.int32),
                                      want_s.view(np.int32))
        count = np.isfinite(masked) if form == "masked" else alive
        np.testing.assert_array_equal(present.numpy(), count.sum(axis=1))


def level_tables():
    """A (GU, GV) level map of two levels and a dead band, their canvas
    offsets, inverse scales and the window."""
    level_id = np.full((GU, GV), -1, np.int32)
    level_id[:10, :15] = 0
    level_id[10:, 2:] = 1
    offsets = np.array([[0, 0], [10, 2]], np.int32)
    inv_scales = np.array([1.0, 1.5], np.float32)
    return level_id, offsets, inv_scales, np.array([8, 8], np.int32)


@pytest.mark.parametrize("miscount", [0, 1, -1])
@pytest.mark.parametrize("k", [1, 37, 64, N])
@pytest.mark.parametrize("kind", ["ties", "around_k", "far_above",
                                  "all_inf"])
def test_extract_detections_masked_matches_jax(kind, k, miscount):
    """extract_detections_masked (the dense extraction over topk_masked)
    against JAX's on each row: boxes, scores, validity, the count (-1 on
    overflow or where the given count differs from the map's by
    ``miscount``) and the canvas origins."""
    _, _, masked = maps(kind, k, seed=7)
    level_id, offsets, inv_scales, window = level_tables()
    for b in range(B):
        count = int(np.isfinite(masked[b]).sum()) + miscount
        grid = masked[b].reshape(GU, GV)
        want = [np.asarray(a) for a in jnms.extract_detections_masked(
            jnp.asarray(grid), jnp.int32(count), jnp.asarray(level_id),
            jnp.asarray(offsets), jnp.asarray(inv_scales),
            jnp.asarray(window), k=k, with_coords=True)]
        got = [a.numpy() for a in tnms.extract_detections_masked(
            torch.from_numpy(grid.copy()), count, torch.from_numpy(level_id),
            torch.from_numpy(offsets), torch.from_numpy(inv_scales), window,
            k=k, with_coords=True)]
        if k in (1, N):  # XLA:CPU's own order of ties (ROADMAP §C)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_array_equal(got[3], want[3])
            continue
        for name, g, w in zip(("rects", "scores", "valid", "count", "rs",
                               "cs"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("miscount", [0, 1, -1, 5])
@pytest.mark.parametrize("cap", [5, 37, 64, 399])
def test_complete_count_matches_jax_two_phase(cap, miscount):
    """complete_count (two-phase serving's check that the compaction
    captured every prefix survivor) against JAX's expression in
    ``_make_two_phase_detector_boxes``, with the given count off the
    map's by ``miscount``: count -1 and complete False where they
    differ, on the device, where the compaction used to raise."""
    _, _, masked = maps("around_k", cap, seed=11)
    count1 = np.isfinite(masked).sum(axis=1).astype(np.int32) + miscount
    scores, _, _ = tnms.topk_masked(torch.from_numpy(masked.copy()), cap)
    got_count, got_complete = tnms.complete_count(
        scores, torch.from_numpy(count1), cap)
    for b in range(B):
        ws, _ = jax.lax.approx_max_k(jnp.asarray(masked[b]), cap,
                                     recall_target=1.0)
        complete = jnp.logical_and(
            count1[b] <= cap,
            jnp.sum(jnp.isfinite(ws), dtype=jnp.int32) == count1[b])
        assert bool(got_complete[b]) == bool(complete)
        assert int(got_count[b]) == int(jnp.where(complete, count1[b], -1))


def test_compact_survivors_takes_any_count():
    """compact_survivors no longer reads the count it is given: a wrong
    one neither raises nor changes the compaction."""
    _, _, masked = maps("ties", 37, seed=2)
    m = torch.from_numpy(masked.copy()).reshape(B, GU, GV)
    right = torch.from_numpy(np.isfinite(masked).sum(axis=1).astype(np.int32))
    a = tnms.compact_survivors(m, right, 37)
    b = tnms.compact_survivors(m, right + 3, 37)
    plain = tnms.compact_survivors_plain(m, right + 3, 37)
    for x, y, z in zip(a, b, plain):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_topk_shapes_and_checks():
    """One row unbatched, k = 0, and what topk_masked refuses."""
    hs, alive, masked = maps("ties", 37)
    one = tnms.topk_masked(torch.from_numpy(masked[3].copy()), 37)
    full = tnms.topk_masked(torch.from_numpy(masked.copy()), 37)
    assert one[0].shape == (37,) and one[2].shape == ()
    for o, f in zip(one, full):
        assert torch.equal(o, f[3])
    empty = tnms.topk_masked(torch.from_numpy(masked.copy()), 0)
    assert empty[0].shape == empty[1].shape == (B, 0)
    np.testing.assert_array_equal(empty[2].numpy(),
                                  np.isfinite(masked).sum(axis=1))
    t = torch.from_numpy(masked.copy())
    with pytest.raises(ValueError):
        tnms.topk_masked(t, N + 1)
    with pytest.raises(ValueError):
        tnms.topk_masked(t, -1)
    with pytest.raises(ValueError):
        tnms.topk_masked(t.double(), 3)
    with pytest.raises(ValueError):
        tnms.topk_masked(t, 3, alive=torch.from_numpy(alive[:2].copy()))
    with pytest.raises(ValueError):
        tnms.topk_masked(t, 3, alive=torch.from_numpy(alive.copy()).int())


def _box_tables(bad):
    """The arguments of ``ops/nms.py::_box_tables`` for the (B, N) rows of
    :func:`level_tables`' grid, with the table ``bad`` names made wrong
    (``None``: none)."""
    level_id, offsets, inv_scales, _ = level_tables()
    t = dict(count=torch.zeros(B, dtype=torch.int32),
             level_id=torch.from_numpy(level_id).long(),
             offsets=torch.from_numpy(offsets).long(),
             inv_scales=torch.from_numpy(inv_scales))
    if bad is not None:
        name, how = bad.split("/")
        t[name] = {"int64": lambda x: x.long(),
                   "int32": lambda x: x.int(),
                   "float64": lambda x: x.double(),
                   "short": lambda x: x[:-1],
                   "narrow": lambda x: x[..., :-1],
                   "wide": lambda x: torch.cat([x, x[:, :1]], 1),
                   "empty": lambda x: x[:0],
                   "meta": lambda x: x.to("meta")}[how](t[name])
    flat = torch.zeros((B, N), dtype=torch.float32)
    return flat, t["count"], t["level_id"], t["offsets"], t["inv_scales"]


@pytest.mark.parametrize("bad", [
    "count/int64", "count/short", "count/meta", "level_id/int32",
    "level_id/narrow", "level_id/meta", "offsets/int32", "offsets/wide",
    "offsets/empty", "offsets/meta", "inv_scales/float64",
    "inv_scales/short", "inv_scales/meta"])
def test_extract_box_tables_refused(bad):
    """What the card's extraction refuses before its launch
    (``_box_tables``, checked on the host): each table of another dtype,
    shape or device than the map's rows ask for, a ValueError naming
    it (the levels L are the offsets' rows, at least one); right tables
    come back unchanged."""
    name = bad.split("/")[0]
    with pytest.raises(ValueError, match=f"^extract_detections: {name} "
                                         "must be a "):
        tnms._box_tables(*_box_tables(bad), GV)
    flat, *want = _box_tables(None)
    got = tnms._box_tables(flat, *want, GV)
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w)
