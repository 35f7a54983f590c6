"""PyTorch port, kernel B1 (plain version on the CPU): the uint8 octave
chain and the polyphase planes of every pyramid level, bitwise against
the JAX package's plane functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldboost_tpu import model as M
from waldboost_tpu.channels import _compute_octaves_f32, _normalize_opts
from waldboost_tpu.ops.channels_pallas import plane_pad_geometry

from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import packing

from torch_port_util import noise_frames, port_planes

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(48, 64), (97, 131)])
def test_octave_chain_matches_jax(hw):
    img = noise_frames(1, hw, seed=1)[0]
    want = _compute_octaves_f32(jnp.asarray(img), 4)
    got = tch.level_octaves(torch.from_numpy(img[None]), 4)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g[0].numpy().astype(np.float32),
                                      np.asarray(w_))


def _port_packed(h, w, n_per_oct, window):
    return packing._packed_plan_cached(h, w, 2, n_per_oct, window, halo=1)


def _jax_setup(h, w, n_per_oct, window):
    opts = dict(shrink=2, n_per_oct=n_per_oct, smooth=1,
                channels="grad_hist")
    _, _, _, cf = _normalize_opts(opts)
    packed = M._packed_plan_cached(h, w, 2, n_per_oct, window, halo=cf.halo)
    geom = plane_pad_geometry(packed.canvas_h, packed.canvas_w)
    return cf, packed, geom


def _content(planes, packed, geom):
    pr, pc, _, _ = geom
    return planes[..., pr:pr + packed.canvas_h, pc:pc + packed.canvas_w]


@pytest.mark.parametrize("hw,npo", [((48, 64), 2), ((96, 128), 2),
                                    ((160, 256), 4)])
def test_planes_match_jax_mats_path(hw, npo):
    """Planes equal M._poly_planes over the prebuilt selector matrices on
    the content region; the JAX padding outside it is zero."""
    h, w = hw
    window = (8, 8)
    imgs = noise_frames(2, hw, seed=7)
    cf, packed, geom = _jax_setup(h, w, npo, window)
    mats, spec = M._poly_mats_cached(packed, packed.halo, (h, w))
    ref = jax.vmap(lambda im: M._poly_planes(im, cf, packed, geom=geom,
                                             mats=mats, spec=spec))(
        jnp.asarray(imgs))
    ref = np.array(ref.astype(jnp.float32))
    content = _content(ref, packed, geom).copy()
    _content(ref, packed, geom)[...] = 0
    assert not ref.any()
    got = port_planes(imgs, _port_packed(h, w, npo, window)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got.astype(np.float32), content)


@pytest.mark.parametrize("hw", [(48, 64), (96, 128)])
@pytest.mark.parametrize("merged", ["0", "1"])
def test_planes_match_jax_fused_kernel(merged, hw, monkeypatch):
    """Planes equal the fused Pallas shelf kernel run in interpret mode:
    the chained per-shelf calls (``shelf_pass2_call``, B1) and, with
    ``WB_SHELF_MERGED=1``, the single-launch multi-shelf kernel
    (``multi_shelf_pass2_call``, B1m); the port's plane kernel is one
    launch over every level either way."""
    monkeypatch.setenv("WB_SHELF_MERGED", merged)
    h, w = hw
    window = (8, 8)
    imgs = noise_frames(2, (h, w), seed=5)
    _, packed, geom = _jax_setup(h, w, 2, window)
    fmats, fspec = M._poly_fused_cached(packed, packed.halo, (h, w))
    assert fspec["merged"] is not None  # 1 shelf at 48x64, 2 at 96x128
    ref = M._poly_planes_fused(jnp.asarray(imgs), fmats, fspec,
                               interpret=True)
    ref = _content(np.asarray(ref.astype(jnp.float32)), packed, geom)
    got = port_planes(imgs, _port_packed(h, w, 2, window)).numpy()
    np.testing.assert_array_equal(got.astype(np.float32), ref)
