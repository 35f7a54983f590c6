"""PyTorch port, kernels B4 and B6 (plain versions on the CPU): the
unmasked ``(hs, alive, n_weak)`` of a cascade at every window origin, held
bitwise against the JAX package's Pallas kernels in interpret mode
(``cascade_response_grid_static`` for B4, ``cascade_response_grid_pallas``
for B6) and the XLA ``cascade_response_grid``: ``hs`` at every origin, dead
ones included, ``alive`` and ``n_weak``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldboost_tpu.ops.cascade import cascade_response_grid as jax_xla_grid
from waldboost_tpu.ops.cascade_pallas import cascade_response_grid_pallas
from waldboost_tpu.ops.cascade_static import (cascade_response_grid_static,
                                              static_cascade_from_model)

from waldboost_tpu_torch import packing
from waldboost_tpu_torch.ops import cascade as tc
from waldboost_tpu_torch.ops import cascade_static as tcs

from torch_port_util import make_model_pair, noise_frames, port_canvas

torch.set_num_threads(1)


def _setup(hw, npo, shape, n_stages, depth, seed=4):
    jm, tm = make_model_pair(n_stages=n_stages, shape=shape, seed=seed,
                             n_per_oct=npo, depth=depth)
    window = shape[:2]
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, npo, window,
                                         halo=1)
    canvas = port_canvas(noise_frames(2, hw, seed=9), packed)
    return jm, tm, window, canvas, packed.valid_mask(window)


def _assert_maps_equal(got, want, valid):
    hs, alive, n_weak = (np.asarray(a) for a in got)
    jhs, jalive, jnw = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(alive, jalive)
    np.testing.assert_array_equal(hs, jhs)  # every origin, dead ones too
    np.testing.assert_array_equal(n_weak, jnw)
    # the cascade kept some windows and rejected others, and a rejected
    # window's hs is observable (nonzero)
    assert 0 < alive.sum() < valid.sum() * (alive.size // valid.size)
    assert (hs[~alive & valid] != 0).any()
    assert (hs[..., ~valid] == 0).all()


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("hw,npo,shape,n_stages,depth,cap", [
    ((96, 128), 2, (8, 8, 4), 20, None, None),
    ((96, 128), 2, (8, 8, 4), 20, None, 12),
    ((48, 64), 2, (8, 8, 4), 40, 5, None),
    ((48, 64), 2, (8, 8, 4), 40, 5, 7),
])
def test_b4_plain_matches_jax_static(hw, npo, shape, n_stages, depth, cap,
                                     batched):
    jm, tm, window, canvas, valid = _setup(hw, npo, shape, n_stages, depth)
    ops = tcs.CascadeOperands.build(tcs.static_cascade_from_model(tm),
                                    window, 4, "cpu")
    cv = canvas if batched else canvas[:1]
    got = tcs.cascade_response(cv, torch.from_numpy(valid.astype(np.uint8)),
                               ops, n_stages_cap=cap)
    want = cascade_response_grid_static(
        jnp.asarray(cv.numpy() if batched else cv[0].numpy()),
        static_cascade_from_model(jm), jnp.asarray(valid), window,
        interpret=True, n_stages_cap=cap)
    if not batched:
        got = tuple(a[0] for a in got)
    _assert_maps_equal(got, want, valid)
    # the stage cap stops every window: n_weak counts only capped stages
    if cap is not None:
        full = tcs.cascade_response_plain(
            cv, torch.from_numpy(valid.astype(np.uint8)), ops)
        assert (got[2] <= full[2]).all()


@pytest.mark.parametrize("hw,npo,shape,n_stages,depth", [
    ((96, 128), 2, (8, 8, 4), 20, None),   # complete heaps, bucket 24
    ((48, 64), 2, (8, 8, 4), 40, 5),       # general trees, bucket 64
])
def test_b6_plain_matches_jax_pallas_and_xla(hw, npo, shape, n_stages,
                                             depth):
    jm, tm, window, canvas, valid = _setup(hw, npo, shape, n_stages, depth)
    jcasc, jmeta = jm._get_cascade()
    tcasc, tmeta = tm._get_cascade()
    assert tcasc.n_stages > n_stages  # inactive padding stages
    assert tmeta.complete == (depth is None)
    got = tc.cascade_response_grid(canvas, tcasc, window,
                                   torch.from_numpy(valid))
    for i in range(canvas.shape[0]):
        cv = jnp.asarray(canvas[i].numpy())
        for want in (cascade_response_grid_pallas(cv, jcasc,
                                                  jnp.asarray(valid), window,
                                                  jmeta, interpret=True),
                     jax_xla_grid(cv, jcasc, window, jmeta,
                                  init_alive=jnp.asarray(valid))):
            _assert_maps_equal(tuple(a[i] for a in got), want, valid)
    # one (C, H, W) image gives the batch's first entry
    single = tc.cascade_response_grid(canvas[0], tcasc, window,
                                      torch.from_numpy(valid))
    for a, b in zip(single, got):
        assert torch.equal(a, b[0])
    # the plain version is what a CPU tensor takes
    plain = tc.cascade_response_grid_plain(canvas, tcasc, window,
                                           torch.from_numpy(valid))
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


def test_b6_theta_compare_rejects_non_finite():
    """B6 rejects unless ``hs >= theta`` (a NaN or +inf theta kills every
    window, as in JAX); B4 ignores non-finite thetas, as the static kernel
    does."""
    jm, tm, window, canvas, valid = _setup((48, 64), 2, (8, 8, 4), 4, None)
    tm.theta[1] = float("nan")
    tm._version += 1
    tcasc, tmeta = tm._get_cascade()
    hs, alive, n_weak = tc.cascade_response_grid(canvas, tcasc, window,
                                                 torch.from_numpy(valid))
    assert not alive.any()
    assert (n_weak == 2 * int(valid.sum())).all()
    ops = tcs.CascadeOperands.build(tcs.static_cascade_from_model(tm),
                                    window, 4, "cpu")
    _, alive4, _ = tcs.cascade_response(
        canvas, torch.from_numpy(valid.astype(np.uint8)), ops)
    assert alive4.any()
