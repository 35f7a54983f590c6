"""Public functions of the JAX package that the port gives under JAX's
names: ``ops.cascade.cascade_stage_responses``, ``ops.nms.
iou_matrix_device``, ``extract_detections_masked`` and ``nms_device`` on
one candidate set, and ``PackedPyramidPlan.level_interior_mask``,
against the JAX package on the CPU with numpy-seeded inputs (a separate
buffer for each package).  Tolerance 0: every output bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldboost_tpu.ops import cascade as jcasc
from waldboost_tpu.ops import nms as jnms
from waldboost_tpu.packing import _packed_plan_cached as jax_plan

from waldboost_tpu_torch.ops import cascade as tcasc
from waldboost_tpu_torch.ops import nms as tnms
from waldboost_tpu_torch.packing import _packed_plan_cached as port_plan

from torch_port_util import make_model_pair, noise_frames, port_canvas

torch.set_num_threads(4)

HW = (48, 64)


@pytest.mark.parametrize("depth", [None, 5])
def test_cascade_stage_responses_matches_jax(depth):
    """Complete heap trees (random depth-2 stages) and general tables
    (depth-5 trees, beyond MAX_COMPLETE_DEPTH), padding stages included,
    over the same grad_hist canvas."""
    jm, tm = make_model_pair(n_stages=12, seed=3, depth=depth)
    jc, jmeta = jm._get_cascade()
    tc, tmeta = tm._get_cascade()
    assert tmeta.complete == (depth is None) == jmeta.complete
    packed = port_plan(*HW, 2, 2, (8, 8), halo=1)
    canvas = port_canvas(noise_frames(1, HW, seed=4), packed)[0]
    got = tcasc.cascade_stage_responses(canvas, tc, (8, 8), tmeta)
    want = jcasc.cascade_stage_responses(jnp.asarray(canvas.numpy().copy()),
                                         jc, (8, 8), jmeta)
    C, U, V = canvas.shape
    assert got.shape == (tc.n_stages, U - 8, V - 8) and got.dtype == \
        torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[len(tm):] == 0).all() and got[:len(tm)].abs().sum() > 0


def _rects(rng, n):
    xy = rng.uniform(0, 40, (n, 2)).astype(np.float32)
    wh = rng.uniform(0, 12, (n, 2)).astype(np.float32)
    wh[::7] = 0  # empty boxes: a zero union
    return np.concatenate([xy, xy + wh], axis=1)


def test_iou_matrix_device_matches_jax():
    rng = np.random.RandomState(5)
    a, b = _rects(rng, 37), _rects(rng, 23)
    got = tnms.iou_matrix_device(torch.from_numpy(a.copy()),
                                 torch.from_numpy(b.copy()))
    want = jnms.iou_matrix_device(jnp.asarray(a.copy()), jnp.asarray(b.copy()))
    assert got.shape == (37, 23)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_nms_device_one_candidate_set_matches_jax(thr):
    """JAX's signature: (K,) candidates, the default threshold 0.5."""
    rng = np.random.RandomState(6)
    rects = _rects(rng, 64)
    scores = rng.rand(64).astype(np.float32)
    valid = rng.rand(64) < 0.8
    args = (rects, scores, valid)
    got = tnms.nms_device(*(torch.from_numpy(a.copy()) for a in args),
                          iou_threshold=thr)
    want = jnms.nms_device(*(jnp.asarray(a.copy()) for a in args),
                           iou_threshold=thr)
    assert got.shape == (64,) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if thr == 0.5:
        np.testing.assert_array_equal(
            tnms.nms_device(*(torch.from_numpy(a.copy()) for a in args))
            .numpy(), got.numpy())


@pytest.mark.parametrize("with_coords", [False, True])
@pytest.mark.parametrize("k,n_alive", [(256, 100), (64, 100), (256, 0)])
def test_extract_detections_masked_matches_jax(k, n_alive, with_coords):
    """One masked map (distinct scores where alive, -inf elsewhere) over a
    packed plan's level maps: complete, overflowing (count -1) and empty;
    a count that disagrees with the map comes back -1 too."""
    packed = port_plan(*HW, 2, 2, (8, 8), halo=1)
    level_id, inv_scales = packed.level_maps((8, 8))
    offsets = np.array([(pl.y, pl.x) for pl in packed.levels], np.int32)
    valid = packed.valid_mask((8, 8))
    rng = np.random.RandomState(7)
    masked = np.full(valid.shape, -np.inf, np.float32)
    idx = rng.choice(np.flatnonzero(valid), n_alive, replace=False)
    masked.flat[idx] = rng.permutation(n_alive).astype(np.float32) / 7.0
    for count in (n_alive, n_alive + 1):
        args = (masked, np.int32(count), level_id.astype(np.int32), offsets,
                inv_scales.astype(np.float32))
        got = tnms.extract_detections_masked(
            *(torch.as_tensor(np.array(a)) for a in args),
            torch.tensor([8, 8]), k=k, with_coords=with_coords)
        want = jnms.extract_detections_masked(
            *(jnp.asarray(np.array(a)) for a in args),
            jnp.asarray([8, 8], jnp.int32), k=k, with_coords=with_coords)
        assert len(got) == len(want) == (6 if with_coords else 4)
        v = np.asarray(want[2])
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, i
            if i >= 4:  # origins: JAX leaves them unspecified where ~valid
                g, w = g[v], w[v]
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        assert int(got[3]) == (count if count <= k and count == n_alive
                               else -1)


@pytest.mark.parametrize("hw,window,halo", [((48, 64), (8, 8), 1),
                                            ((97, 131), (12, 12), 6),
                                            ((64, 64), (0, 0), 0)])
def test_level_interior_mask_matches_jax(hw, window, halo):
    got = port_plan(*hw, 2, 3, window, halo=halo).level_interior_mask()
    want = jax_plan(*hw, 2, 3, window, halo=halo).level_interior_mask()
    assert got.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)
