"""The port's per-level channel pyramid (``channels.channel_pyramid``,
``Model.channels``, ``Model.scan_channels``) against the JAX package's on
the same numpy-seeded uint8 frames, on the CPU.

Tolerance: channels bitwise except where both sides are below 2**-30 in
magnitude (the exact-cancellation lines of JAX's XLA chain, PARITY.md
section 1c); scales, survivors, scores and the eval-cost counters
bitwise.
"""

import numpy as np
import pytest
import torch

from waldboost_tpu import channels as jch

import waldboost_tpu_torch as wt
from waldboost_tpu_torch import channels as tch

from torch_port_util import make_model_pair, noise_frames

torch.set_num_threads(4)


def _assert_levels_equal(got, want):
    assert len(got) == len(want) > 0
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb and a.shape == b.shape and a.dtype == b.dtype
        tiny = (np.abs(a) < 2.0 ** -30) & (np.abs(b) < 2.0 ** -30)
        np.testing.assert_array_equal(np.where(tiny, 0, a),
                                      np.where(tiny, 0, b))


@pytest.mark.parametrize("channels", ["grad_hist", "grad_hist_4_u1"])
@pytest.mark.parametrize("smooth", [0, 1])
def test_channel_pyramid_matches_jax(channels, smooth):
    """Every level of the plan, 9 and 12 of them down to 2 x 3 channels,
    on frames of two sizes (one odd)."""
    for i, hw in enumerate(((48, 64), (97, 131))):
        img = noise_frames(1, hw, seed=40 + i)[0]
        opts = dict(shrink=2, n_per_oct=3, smooth=smooth, channels=channels)
        _assert_levels_equal(
            list(tch.channel_pyramid(img, opts, device="cpu")),
            list(jch.channel_pyramid(img, opts)))


@pytest.mark.parametrize("smooth", [0, 1])
def test_channel_pyramid_float_near_jax(smooth):
    """A float32 frame: every level within PARITY.md's 16-ULP float
    contract of JAX's per-level chain (double-float resize and
    prefilters), over 99% of the values bitwise (measured: at most 8 ULP,
    99.78% bitwise; the port's values are the float64 reference's)."""
    rng = np.random.RandomState(1)
    img = (rng.randint(0, 256, (48, 64)) + rng.rand(48, 64)).astype(
        np.float32)
    opts = dict(shrink=2, n_per_oct=2, smooth=smooth, channels="grad_hist")
    got = list(tch.channel_pyramid(img, opts, device="cpu"))
    want = list(jch.channel_pyramid(img, opts))
    assert len(got) == len(want) == 6
    same = total = 0
    for (a, sa), (b, sb) in zip(got, want):
        b = np.asarray(b)
        assert sa == sb and a.shape == b.shape and a.dtype == np.float32
        ka, kb = (np.where(x.view(np.int32) < 0,
                           -(x.view(np.int32) & 0x7FFFFFFF),
                           x.view(np.int32)).astype(np.int64) for x in (a, b))
        assert np.abs(ka - kb).max() <= 16
        same += int((a == b).sum())
        total += a.size
    assert same >= 0.99 * total


def test_channel_pyramid_errors():
    opts = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist")
    img = noise_frames(1, (48, 64), seed=1)[0]
    with pytest.raises(ValueError, match="2 dimensions"):
        list(tch.channel_pyramid(img[None], opts, device="cpu"))
    # float images are served (exact float frames): the float canvas's
    # levels, held against JAX in test_channel_pyramid_float_near_jax
    assert len(list(tch.channel_pyramid(img.astype(np.float32), opts,
                                        device="cpu"))) == 6
    with pytest.raises(ValueError, match="uint8 or float32"):
        list(tch.channel_pyramid(img.astype(np.int16), opts, device="cpu"))
    # shrink 1 is served (the image-space canvas), one entry per level of
    # the plan; its values are held against JAX in test_torch_canvas.py
    assert len(list(tch.channel_pyramid(img, dict(opts, shrink=1),
                                        device="cpu"))) == \
        len(tch.pyramid_plan(48, 64, 1, 2))
    assert list(tch.channel_pyramid(img[:6, :6], opts, device="cpu")) == []


@pytest.mark.parametrize("smooth,channels,thr_max", [
    (1, "grad_hist", 300.0), (0, "grad_hist_4_u1", 16.0)])
def test_scan_channels_matches_jax(smooth, channels, thr_max):
    """Model.channels and Model.scan_channels level by level: channels,
    scales, survivors and scores, then the eval-cost counters (thresholds
    over each family's value range)."""
    jm, tm = make_model_pair(n_stages=8, seed=3, smooth=smooth,
                             channels=channels, thr_max=thr_max)
    img = noise_frames(1, (97, 131), seed=4)[0]
    _assert_levels_equal(list(tm.channels(img)), list(jm.channels(img)))
    got, want = list(tm.scan_channels(img)), list(jm.scan_channels(img))
    _assert_levels_equal([g[:2] for g in got], [w[:2] for w in want])
    assert sum(len(w[2][0]) for w in want) > 0
    for (_, _, g), (_, _, w) in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for k in ("n_weak", "n_loc", "n_images", "eval_cost"):
        assert tm.cost_stats()[k] == jm.cost_stats()[k], k
