"""Image operations of the per-level channel pyramid: pooling, smoothing,
separable filters, gradients and the bilinear resize.

Counterpart of ``waldboost_tpu/ops/image.py``, under its names and
parameters, in plain torch on the input's device.  Every function takes
tensors of any leading shape and works on the last two (H, W) dims.
The reference's quirks are kept:

* ``avg_pool_2`` sums in the input dtype (uint8 wraps mod 256, the row
  pair first, then the column pair), divides by 4 in float32 and casts
  back (truncating integers); float inputs sum ``((TL + BL) + TR) + BR``;
* ``smooth_3x3`` sums the nine taps in the stencil's row-major float32
  order, writes 0 on the one-pixel border and casts back;
* ``gradients`` and ``separable_filter_reflect`` read symmetric-reflect
  edges (``d c b a | a b c d``, repeated for pads wider than the image);
  the derivative tap is ``x[i-1] - x[i+1]``;
* ``resize_bilinear`` has skimage's half-pixel-centre ``order=1``
  semantics: integer images take the exact rational taps and one floor,
  float images the float64 two-pass lerp rounded once (native f64 where
  JAX emulates it in double-float), and the result is cast back to the
  input dtype.

No operation here is fused, so the card gives the CPU's values bitwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .exact import axis_taps_exact, resize_taps64

__all__ = ["avg_pool_2", "max_pool_2", "smooth_3x3", "gradients",
           "separable_filter_reflect", "conv2d_exact", "triangle_kernel",
           "resize_bilinear", "GRAD_KX", "GRAD_KY"]

#: correlation kernels of the reference's smoothed gradients (scipy's
#: convolve1d flips [-1, 0, 1]: ``x[i-1] - x[i+1]``)
GRAD_KX = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
GRAD_KY = GRAD_KX.T.copy()


def _is_integer(t: torch.Tensor) -> bool:
    return not t.is_floating_point() and not t.is_complex() \
        and t.dtype != torch.bool


def _even(t: torch.Tensor) -> torch.Tensor:
    """``t`` with an odd last row and column dropped."""
    return t[..., :t.shape[-2] // 2 * 2, :t.shape[-1] // 2 * 2]


def avg_pool_2(arr: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2x2 average pool over the last two dims, odd edges
    dropped.  Integer inputs sum in their own dtype (uint8 wraps mod 256:
    the row pair, then the column pair), divide by 4 in float32 and
    truncate back; float inputs compute ``(((TL + BL) + TR) + BR) / 4`` in
    their dtype."""
    x = _even(arr)
    if _is_integer(arr):
        s = x[..., 0::2, :] + x[..., 1::2, :]
        s = s[..., 0::2] + s[..., 1::2]
        return (s.to(torch.float32) / 4.0).to(arr.dtype)
    tl, bl = x[..., 0::2, 0::2], x[..., 1::2, 0::2]
    tr, br = x[..., 0::2, 1::2], x[..., 1::2, 1::2]
    return (((tl + bl) + tr) + br) / 4


def max_pool_2(arr: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2x2 max pool over the last two dims, odd edges
    dropped."""
    x = _even(arr)
    rows = torch.maximum(x[..., 0::2, :], x[..., 1::2, :])
    return torch.maximum(rows[..., 0::2], rows[..., 1::2])


def smooth_3x3(arr: torch.Tensor) -> torch.Tensor:
    """The 3x3 binomial ([1 2 1] x [1 2 1]) / 16 smooth over the last two
    dims: the nine taps summed left to right in row-major order in float32,
    0 on the border, cast back to the input dtype (integers truncate)."""
    work = arr.to(torch.float32)
    H, W = work.shape[-2], work.shape[-1]

    def at(dr, dc):
        return work[..., 1 + dr:H - 1 + dr, 1 + dc:W - 1 + dc]

    v = at(-1, -1) + 2.0 * at(-1, 0) + at(-1, 1) \
        + 2.0 * at(0, -1) + 4.0 * at(0, 0) + 2.0 * at(0, 1) \
        + at(1, -1) + 2.0 * at(1, 0) + at(1, 1)
    v = (v / 16.0).to(arr.dtype)
    return torch.nn.functional.pad(v, (1, 1, 1, 1))


def pad_reflect(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Symmetric padding ``d c b a | a b c d`` by ``n`` along ``dim``,
    reflected again where ``n`` exceeds the size (numpy's
    ``mode="symmetric"``)."""
    size = x.shape[dim]
    if n <= 0:
        return x
    if n <= size:
        head = x.narrow(dim, 0, n).flip(dim)
        tail = x.narrow(dim, size - n, n).flip(dim)
        return torch.cat([head, x, tail], dim)
    j = np.arange(-n, size + n) % (2 * size)
    j = np.where(j >= size, 2 * size - 1 - j, j)
    return x.index_select(dim, torch.as_tensor(j, device=x.device))


def taps(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """``x`` along ``dim`` from ``lo`` to ``size - hi``: the window of a
    padded array's tap at offset ``lo``."""
    return x.narrow(dim, lo, x.shape[dim] - lo - hi)


def _conv1d(x: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """Correlation of a padded array with a small kernel along ``dim`` by
    shifted adds, left to right; zero taps are skipped and unit taps are
    not multiplied."""
    k = len(kernel)
    out = None
    for j, wgt in enumerate(kernel):
        if wgt == 0:
            continue
        term = taps(x, dim, j, k - 1 - j)
        if wgt != 1:
            term = term * torch.tensor(float(wgt), dtype=x.dtype,
                                       device=x.device)
        out = term if out is None else out + term
    return out


def separable_filter_reflect(x: torch.Tensor, k0: np.ndarray,
                             k1: Optional[np.ndarray] = None) -> torch.Tensor:
    """Separable correlation with symmetric-reflect edges over the last two
    dims: ``k0`` down the columns, then ``k1`` (``k0`` when None) along the
    rows, each as float32 taps summed in the input dtype (scipy's
    ``convolve1d`` for the symmetric kernels the callers pass)."""
    k1 = k0 if k1 is None else k1
    x = pad_reflect(x, len(k0) // 2, -2)
    x = _conv1d(x, np.asarray(k0, np.float32), -2)
    x = pad_reflect(x, len(k1) // 2, -1)
    return _conv1d(x, np.asarray(k1, np.float32), -1)


def conv2d_exact(x: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """(H, W) or (B, H, W) input x (O, kh, kw) kernels -> (O, H-kh+1,
    W-kw+1) or (B, O, ...) VALID correlation in float32, the taps summed
    in row-major order by shifted adds (no convolution library, so no
    TF32); exact on integer-valued content, as JAX's HIGHEST-precision
    convolution is."""
    kern = np.asarray(kern, np.float32)
    x = x.to(torch.float32)
    O, kh, kw = kern.shape
    H, W = x.shape[-2], x.shape[-1]
    outs = []
    for o in range(O):
        acc = None
        for r in range(kh):
            for c in range(kw):
                wgt = float(kern[o, r, c])
                if wgt == 0:
                    continue
                term = x[..., r:H - kh + 1 + r, c:W - kw + 1 + c] * wgt
                acc = term if acc is None else acc + term
        if acc is None:
            acc = x.new_zeros(x.shape[:-2] + (H - kh + 1, W - kw + 1))
        outs.append(acc)
    return torch.stack(outs, dim=-3)


def triangle_kernel(n: int) -> np.ndarray:
    """The normalised float32 triangle kernel of radius ``n``."""
    H = (np.concatenate([np.arange(n + 1), np.arange(n - 1, -1, -1)])
         + 1).astype(np.float32)
    return H / H.sum()


def _prefilter(x: torch.Tensor, dim: int, wide: bool) -> torch.Tensor:
    """[1, 2, 1] along ``dim`` of a 1-padded float32 array: ``wide``,
    summed in float64 as scipy's symmetric correlation, ``2*b + (a + c)``,
    and rounded to float32 once; else ``(a + 2b) + c`` in float32."""
    a, b, c = taps(x, dim, 0, 2), taps(x, dim, 1, 1), taps(x, dim, 2, 0)
    if not wide:
        return a + 2.0 * b + c
    return (b.double() * 2.0 + (a.double() + c.double())).to(torch.float32)


def gradients(image: torch.Tensor, float_dd: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gx, gy)`` smoothed gradients of (..., H, W) images as float32:
    the [1, 2, 1] prefilter across, then ``x[i-1] - x[i+1]`` along, with
    symmetric-reflect edges.  ``float_dd``: each prefilter sum is rounded
    once (float64 here, JAX's double-float), for float content; else
    summed in float32 (exact on integer content)."""
    x = image.to(torch.float32)
    t = _prefilter(pad_reflect(x, 1, -1), -1, float_dd)
    t = pad_reflect(t, 1, -2)
    gy = t[..., :-2, :] - t[..., 2:, :]
    s = _prefilter(pad_reflect(x, 1, -2), -2, float_dd)
    s = pad_reflect(s, 1, -1)
    gx = s[..., :, :-2] - s[..., :, 2:]
    return gx, gy


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def resize_bilinear(image: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bilinear resize of the last two dims to ``(nh, nw)`` with skimage's
    ``resize(order=1, anti_aliasing=False)`` semantics, cast back to the
    input dtype.  Integer images: ``floor(N / (den_r * den_c))`` of the
    exact integer numerator of the four corners and the rational taps of
    ``ops/exact.py::axis_taps_exact``; float images: ``top * (1 - fr) +
    bot * fr`` down the rows, then across the columns on the unrounded
    rows, in float64, rounded to float32 once."""
    nh, nw = int(nh), int(nw)
    h, w = image.shape[-2], image.shape[-1]
    dev = image.device
    if _is_integer(image):
        if (nh, nw) == (h, w):
            return image
        i0r, fnr, den_r = axis_taps_exact(h, nh)
        i0c, fnc, den_c = axis_taps_exact(w, nw)
        x = image.to(torch.int64)
        top = x.index_select(-2, _index(i0r, dev))
        bot = x.index_select(-2, _index(np.minimum(i0r + 1, h - 1), dev))
        c0, c1 = _index(i0c, dev), _index(np.minimum(i0c + 1, w - 1), dev)
        wr1 = _index(fnr, dev)[:, None]
        wc1 = _index(fnc, dev)
        wr0, wc0 = den_r - wr1, den_c - wc1
        left = wr0 * top.index_select(-1, c0) + wr1 * bot.index_select(-1, c0)
        right = wr0 * top.index_select(-1, c1) + wr1 * bot.index_select(-1, c1)
        num = wc0 * left + wc1 * right
        return torch.div(num, den_r * den_c,
                         rounding_mode="floor").to(image.dtype)
    x = image.to(torch.float64)
    if nh != h:
        i0, fr = resize_taps64(h, nh)
        fr_t = torch.as_tensor(fr, device=dev)[:, None]
        omf = torch.as_tensor(1.0 - fr, device=dev)[:, None]
        x = x.index_select(-2, _index(i0, dev)) * omf \
            + x.index_select(-2, _index(np.minimum(i0 + 1, h - 1), dev)) \
            * fr_t
    if nw != w:
        j0, fc = resize_taps64(w, nw)
        fc_t = torch.as_tensor(fc, device=dev)
        omf = torch.as_tensor(1.0 - fc, device=dev)
        x = x.index_select(-1, _index(j0, dev)) * omf \
            + x.index_select(-1, _index(np.minimum(j0 + 1, w - 1), dev)) \
            * fc_t
    return x.to(torch.float32).to(image.dtype)
