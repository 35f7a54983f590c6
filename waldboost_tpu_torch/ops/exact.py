"""Exact rational taps of the uint8 bilinear resize (host side).

Counterpart of ``waldboost_tpu/ops/exact.py:axis_taps_exact`` and of
``waldboost_tpu/ops/warp.py::resize_taps64`` (the float64 taps of float
frames).  On the GPU
the exact floor of the 4-corner combine is plain integer arithmetic,
``floor(N / (den_r * den_c))`` on an int32 numerator (ops/planes.py), so
none of the JAX package's f32 emulation cases are needed.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["axis_taps_exact", "resize_taps64"]


def axis_taps_exact(n_in: int, n_out: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Exact taps of skimage's order-1 resize for ``n_in -> n_out``.

    The coordinate of output index k is ``c_k = (k + 0.5) * n_in / n_out -
    0.5`` clipped to ``[0, n_in - 1]``, ``i0 = min(floor(c), n_in - 2)`` and
    ``frac = c - i0``.  Returns ``(i0 int32[n_out], fnum int32[n_out],
    den)`` with ``frac_k = fnum[k] / den`` exactly; ``den`` is reduced by
    the gcd of all numerators (identity axes give den == 1, fnum == 0).
    """
    k = np.arange(n_out, dtype=np.int64)
    den = 2 * n_out
    c_num = (2 * k + 1) * n_in - n_out          # coordinate * den, exact
    c_num = np.clip(c_num, 0, (n_in - 1) * den)
    if n_in > 1:
        i0 = np.minimum(c_num // den, n_in - 2)
    else:
        i0 = np.zeros_like(c_num)
    fnum = c_num - i0 * den                      # in [0, den]
    # frac == 1 (the i0 <= n_in-2 clamp at exact-integer edge coordinates)
    # moves into the base index: the weight sits wholly on the i0+1 corner
    one = fnum == den
    if one.any():
        i0 = np.where(one, np.minimum(i0 + 1, n_in - 1), i0)
        fnum = np.where(one, 0, fnum)
    g = math.gcd(den, int(np.gcd.reduce(fnum)) if n_out else den)
    if g > 1:
        fnum //= g
        den //= g
    if den > 1 << 15:
        raise ValueError(f"resize {n_in}->{n_out}: denominator {den} "
                         "exceeds 2**15")
    return i0.astype(np.int32), fnum.astype(np.int32), int(den)


def resize_taps64(n_in: int, n_out: int):
    """``(i0 int32 (n_out,), frac float64 (n_out,))``: output row r of a
    half-pixel-centre bilinear resize with edge clamping blends input rows
    ``i0[r]`` and ``min(i0[r] + 1, n_in - 1)`` with weight ``frac[r]``
    (``waldboost_tpu/ops/warp.py::resize_taps64``)."""
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    coords = np.clip(coords, 0.0, n_in - 1.0)
    i0 = np.floor(coords).astype(np.int64)
    i0 = np.minimum(i0, max(n_in - 2, 0))
    return i0.astype(np.int32), coords - i0
