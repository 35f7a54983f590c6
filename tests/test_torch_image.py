"""The port's ``ops/image.py`` against the JAX package's ``ops/image.py`` on
the same numpy-seeded inputs, on the CPU.

Tolerance: integer content bitwise (the uint8 pool's mod-256 wrap, the
truncating casts, the exact resize floor, the reflect boundary);
float32 content within PARITY.md's 16-ULP float contract, the observed
maximum printed (JAX's double-float resize and prefilters against the
port's native float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldboost_tpu.ops import image as jim

from waldboost_tpu_torch.ops import image as tim

torch.set_num_threads(4)

#: odd and even shapes: tests/test_image_ops.py's 21 x 18, and a batch
SHAPES = [(21, 18), (16, 16), (17, 19), (2, 21, 18)]


def rand_image(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.randint(0, 256, shape).astype(dtype)
    return (rng.randint(0, 256, shape) + rng.rand(*shape)).astype(dtype)


def ulps(a, b):
    """Largest float32 ULP distance between two arrays."""
    ka, kb = (np.where(x.view(np.int32) < 0, -(x.view(np.int32) & 0x7FFFFFFF),
                       x.view(np.int32)).astype(np.int64)
              for x in (np.ascontiguousarray(a, np.float32),
                        np.ascontiguousarray(b, np.float32)))
    return int(np.abs(ka - kb).max()) if ka.size else 0


def check(got, want, dtype, name):
    """Bitwise for integer types and integer-valued content, else within
    16 ULP (printed)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (name, got.shape, want.shape, got.dtype, want.dtype)
    if np.issubdtype(np.dtype(dtype), np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    d = ulps(got, want)
    print(f"{name}: max {d} ULP, {(got == want).mean():.4f} bitwise")
    assert d <= 16, name


def both(fn_name, x, *args):
    return (getattr(tim, fn_name)(torch.from_numpy(x.copy()), *args),
            getattr(jim, fn_name)(jnp.asarray(x.copy()), *args))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("fn", ["avg_pool_2", "max_pool_2", "smooth_3x3"])
def test_pool_and_smooth_match_jax(fn, dtype, shape):
    x = rand_image(shape, dtype, seed=3)
    got, want = both(fn, x)
    check(got, want, dtype, fn)


def test_avg_pool_2_uint8_wraps():
    """The uint8 sums wrap mod 256: 200 * 4 = 800 -> 32 -> 8."""
    img = np.full((3, 2, 2), 200, np.uint8)
    got, want = both("avg_pool_2", img)
    assert got.dtype == torch.uint8 and int(got[0, 0, 0]) == 8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smooth_3x3_truncates_integers():
    """Integer channels truncate the /16; the border is zero."""
    img = rand_image((9, 11), np.uint8, seed=8)
    got, want = both("smooth_3x3", img)
    g = got.numpy()
    assert (g[0] == 0).all() and (g[:, -1] == 0).all()
    np.testing.assert_array_equal(g, np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES + [(4, 3), (1, 7)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("float_dd", [False, True])
def test_gradients_match_jax(float_dd, dtype, shape):
    x = rand_image(shape, dtype, seed=5)
    (gx, gy), (jgx, jgy) = both("gradients", x, float_dd)
    integer = np.issubdtype(np.dtype(dtype), np.integer)
    check(gx, jgx, np.int32 if integer else dtype, "gx")
    check(gy, jgy, np.int32 if integer else dtype, "gy")
    if not integer and not float_dd:
        # the float32 chain is JAX's to the bit
        np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))


@pytest.mark.parametrize("shape", [(21, 18), (24, 31), (3, 4), (2, 21, 18)])
@pytest.mark.parametrize("radius", [1, 5])
def test_separable_filter_reflect_matches_jax(radius, shape):
    """The triangle filter: bitwise JAX's float32 taps, reflect edges
    included (pads wider than a 3 x 4 image reflect again)."""
    x = rand_image(shape, np.float32, seed=6)
    k = tim.triangle_kernel(radius)
    np.testing.assert_array_equal(k, jim.triangle_kernel(radius))
    got, want = both("separable_filter_reflect", x, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k1 = np.array([1, 2, 1], np.float32)
    got, want = both("separable_filter_reflect", x, k, k1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(21, 18), (2, 21, 18)])
@pytest.mark.parametrize("integer", [True, False])
def test_conv2d_exact_matches_jax(integer, shape):
    x = rand_image(shape, np.uint8 if integer else np.float32, seed=7)
    x = x.astype(np.float32)
    kern = np.stack([tim.GRAD_KX, tim.GRAD_KY, np.full((3, 3), 0.25, "f")])
    np.testing.assert_array_equal(tim.GRAD_KX, jim.GRAD_KX)
    np.testing.assert_array_equal(tim.GRAD_KY, jim.GRAD_KY)
    got, want = both("conv2d_exact", x, kern)
    check(got, want, np.int32 if integer else np.float32, "conv2d_exact")


@pytest.mark.parametrize("shape", [(21, 18), (2, 21, 18), (48, 64)])
@pytest.mark.parametrize("size", [(11, 9), (21, 18), (21, 7), (40, 36),
                                  (6, 37)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_bilinear_matches_jax(dtype, size, shape):
    """Down, up, one axis only and the identity; uint8 bitwise (the exact
    floor), float32 within 16 ULP, each cast back to its dtype."""
    x = rand_image(shape, dtype, seed=9)
    got, want = both("resize_bilinear", x, *size)
    check(got, want, dtype, f"resize {shape} -> {size}")
