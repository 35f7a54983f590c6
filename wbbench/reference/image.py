"""Level images and their channels, in plain torch.

The reference computes each pyramid level on its own: the uint8 octave
chain, the exact bilinear resize of the octave to the level's size, the
channel function, the 2x2 pool and the 3x3 smooth, then places the level
into the packed canvas.  The arithmetic is the WaldBoost reference's
(``waldboost/channels.py``): every operation here is one elementwise torch
operation with no fused multiply-add, so the card gives the CPU's values.

* uint8 2x2 pools sum in uint8 (wrapping mod 256), the row pair first,
  then divide by 4 in float32 and truncate; float pools sum
  ``((TL + BL) + TR) + BR`` and divide by 4;
* the resize has skimage's half-pixel-centre ``order=1`` taps, taken as
  exact rationals, and one floor of the integer four-corner combine;
* grad_hist: [1, 2, 1] prefilter across and ``x[i-1] - x[i+1]`` along,
  symmetric-reflect edges, float32; each of 4 bins
  ``abs(f32(f64(gx) cos t - f64(gy) sin t))``;
* the FPGA kinds: int32 Sobel with zero borders, ``min(|r| // 4, 255)``;
* the smooth: the nine [1 2 1] x [1 2 1] taps summed in row-major order
  in float32, divided by 16, 0 on the one-pixel border, cast back.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["avg_pool_2", "smooth_3x3", "resize_u8", "grad_hist",
           "fpga_kind", "level_channels", "octaves", "CHANNELS"]

_THETA = np.linspace(0, np.pi, 5)[:-1]
_COS = tuple(float(v) for v in np.cos(_THETA))
_SIN = tuple(float(v) for v in np.sin(_THETA))


def _even(t: torch.Tensor) -> torch.Tensor:
    return t[..., :t.shape[-2] // 2 * 2, :t.shape[-1] // 2 * 2]


def avg_pool_2(x: torch.Tensor) -> torch.Tensor:
    x = _even(x)
    if x.dtype == torch.uint8:
        s = x[..., 0::2, :] + x[..., 1::2, :]
        s = s[..., 0::2] + s[..., 1::2]
        return (s.to(torch.float32) / 4.0).to(torch.uint8)
    tl, bl = x[..., 0::2, 0::2], x[..., 1::2, 0::2]
    tr, br = x[..., 0::2, 1::2], x[..., 1::2, 1::2]
    return (((tl + bl) + tr) + br) / 4


def octaves(frames: torch.Tensor, n: int) -> List[torch.Tensor]:
    out = [frames]
    for _ in range(n - 1):
        out.append(avg_pool_2(out[-1]))
    return out


def smooth_3x3(x: torch.Tensor) -> torch.Tensor:
    w = x.to(torch.float32)
    H, W = w.shape[-2], w.shape[-1]

    def at(dr, dc):
        return w[..., 1 + dr:H - 1 + dr, 1 + dc:W - 1 + dc]

    v = at(-1, -1) + 2.0 * at(-1, 0) + at(-1, 1) \
        + 2.0 * at(0, -1) + 4.0 * at(0, 0) + 2.0 * at(0, 1) \
        + at(1, -1) + 2.0 * at(1, 0) + at(1, 1)
    v = (v / 16.0).to(x.dtype)
    return torch.nn.functional.pad(v, (1, 1, 1, 1))


def _taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(i0, fnum, den)``: output k blends inputs ``i0[k]`` and
    ``i0[k] + 1`` with weight ``fnum[k] / den`` on the second, where the
    source coordinate is ``(k + 0.5) n_in / n_out - 0.5`` clipped to the
    image."""
    k = np.arange(n_out, dtype=np.int64)
    den = 2 * n_out
    c = np.clip((2 * k + 1) * n_in - n_out, 0, (n_in - 1) * den)
    i0 = np.minimum(c // den, n_in - 2) if n_in > 1 else np.zeros_like(c)
    fnum = c - i0 * den
    one = fnum == den
    i0 = np.where(one, np.minimum(i0 + 1, n_in - 1), i0)
    fnum = np.where(one, 0, fnum)
    g = math.gcd(den, int(np.gcd.reduce(fnum)) if n_out else den)
    return i0, fnum // g, den // g


def resize_u8(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """uint8 (..., h, w) to (..., nh, nw): the floor of the exact
    four-corner combine over the rational taps."""
    h, w = img.shape[-2], img.shape[-1]
    if (nh, nw) == (h, w):
        return img
    dev = img.device
    ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    i0r, fr, dr = _taps(h, nh)
    i0c, fc, dc = _taps(w, nw)
    x = img.to(torch.int64)
    top = x.index_select(-2, ix(i0r))
    bot = x.index_select(-2, ix(np.minimum(i0r + 1, h - 1)))
    c0, c1 = ix(i0c), ix(np.minimum(i0c + 1, w - 1))
    wr1, wc1 = ix(fr)[:, None], ix(fc)
    wr0, wc0 = dr - wr1, dc - wc1
    left = wr0 * top.index_select(-1, c0) + wr1 * bot.index_select(-1, c0)
    right = wr0 * top.index_select(-1, c1) + wr1 * bot.index_select(-1, c1)
    num = wc0 * left + wc1 * right
    return torch.div(num, dr * dc, rounding_mode="floor").to(torch.uint8)


def _reflect1(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)


def grad_hist(img: torch.Tensor) -> torch.Tensor:
    """(..., 4, H, W) float32 bins of a uint8 (..., H, W) image."""
    x = img.to(torch.float32)
    t = _reflect1(x, -1)
    t = t[..., :, :-2] + 2.0 * t[..., :, 1:-1] + t[..., :, 2:]
    t = _reflect1(t, -2)
    gy = t[..., :-2, :] - t[..., 2:, :]
    s = _reflect1(x, -2)
    s = s[..., :-2, :] + 2.0 * s[..., 1:-1, :] + s[..., 2:, :]
    s = _reflect1(s, -1)
    gx = s[..., :, :-2] - s[..., :, 2:]
    gx, gy = gx.double(), gy.double()
    return torch.stack([(gx * _COS[k] - gy * _SIN[k]).to(torch.float32).abs()
                        for k in range(4)], dim=-3)


def _sobel(img: torch.Tensor):
    xi = img.to(torch.int32)
    dxr = xi[..., :, 2:] - xi[..., :, :-2]
    dx = dxr[..., :-2, :] + 2 * dxr[..., 1:-1, :] + dxr[..., 2:, :]
    dyc = xi[..., 2:, :] - xi[..., :-2, :]
    dy = dyc[..., :, :-2] + 2 * dyc[..., :, 1:-1] + dyc[..., :, 2:]
    pad = lambda t: torch.nn.functional.pad(t, (1, 1, 1, 1))
    return pad(dx), pad(dy)


def fpga_kind(kind: str, img: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) uint8 responses of one FPGA kind."""
    dx, dy = _sobel(img)
    if kind == "grad_hist_4_u1":
        rs = [dx, torch.div(dx - dy, 2, rounding_mode="trunc"), dy,
              torch.div(dx + dy, 2, rounding_mode="trunc")]
    elif kind == "grad_mag_u1":
        rs = [torch.maximum(dx.abs(), dy.abs())]
    else:
        raise ValueError(f"unknown FPGA kind {kind!r}")
    return torch.stack([torch.clamp(r.abs() // 4, max=255) for r in rs],
                       dim=-3).to(torch.uint8)


#: channel functions by the leaf names model files use: (channels,
#: halo the packer leaves around a level, function)
CHANNELS = {
    "waldboost_tpu.channels.grad_hist": (4, 1, grad_hist),
    "waldboost_tpu.fpga.channels.grad_hist_4_u1":
        (4, 0, lambda im: fpga_kind("grad_hist_4_u1", im)),
    "waldboost_tpu.fpga.channels.grad_mag_u1":
        (1, 0, lambda im: fpga_kind("grad_mag_u1", im)),
}


def level_channels(octave_imgs: torch.Tensor, height: int, width: int,
                   shrink: int, smooth: int, funcs) -> torch.Tensor:
    """(B, C, out_h, out_w) channels of one level, in the functions' own
    type (float32 for grad_hist, uint8 for the FPGA kinds)."""
    im = resize_u8(octave_imgs, height, width)
    chns = torch.cat([CHANNELS[f][2](im) for f in funcs], dim=-3)
    if shrink == 2:
        chns = avg_pool_2(chns)
    if smooth == 1:
        chns = smooth_3x3(chns)
    return chns
