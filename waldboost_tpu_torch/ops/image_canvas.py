"""The image-space channel canvas: shrink 1, and channel functions with no
polyphase form (``grad_mag`` and the composites that hold it).

Counterpart of ``waldboost_tpu/polyphase.py::_channel_canvas_fast``, which
the JAX package computes in XLA, outside any Pallas kernel; so does the
port, in plain torch on the caller's device:

    resize    every level resized from its octave into one image-space
              canvas, each level's halo band filled with the reflection of
              the level (``ops/warp.py::reflect_halos``): one gather of
              four corners per canvas pixel from host tables
              (:func:`image_canvas_tables`), then the exact integer floor
              of uint8 frames (``ops/exact.py::resize_exact_matmul``) or
              the f32 lerp of float frames (``build_resize_matrix``'s
              weights ``1 - frac`` and ``frac``, rows then columns)
    channels  the channel function once over the whole canvas
              (:func:`image_channels`)
    pool      the 2x2 average ``(((TL + BL) + TR) + BR) / 4`` at shrink 2
    smooth    the 3x3/16 smooth in the reference's 9-term order and the
              interior mask at smooth 1 (FPGA channels truncate, as the
              uint8 reference does)

The channel arithmetic is the reference's (``tests/oracle.py``):

* gradients: the [1, 2, 1] prefilter, the derivative ``x[i-1] - x[i+1]``
  in float32, symmetric-reflect edges;
* grad_hist: each prefilter summed in float64 as scipy's symmetric
  correlation sums it, ``2*b + (a + c)``, and rounded once (JAX's
  ``float_dd`` chain); per bin ``f32(f64(gx)*cos - f64(gy)*sin)``, then
  ``abs``;
* grad_mag: the prefilter ``(a + 2b) + c`` in float32, as JAX computes
  it (exact on uint8 content); ``sqrt(gx*gx + gy*gy)`` correctly rounded
  to float32; the magnitude reflected through the level halos again (one
  gather); the triangle filter of radius 5 along rows then columns, each
  pass summed in float64 as scipy does (centre tap first, then the
  symmetric pairs from the outermost in) and rounded once; then ``mag /
  (nrm + 1e-3)`` in float32;
* FPGA kinds: the integer Sobel of the canvas truncated to int32, zero
  around each level (the stencil border mask).

Every operation is an unfused torch op, so the card's canvas equals the
CPU's bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..channels import ChannelFunction, resolve_channel_function
from ..packing import PackedPyramidPlan
from ..polyphase import _octave_layout, resize_taps64
from .channels import project_bins
from .image import (avg_pool_2, gradients, pad_reflect, smooth_3x3, taps,
                    triangle_kernel)

__all__ = ["ImageCanvasTables", "image_canvas_tables", "reflect_map",
           "ImageCanvasOperands", "resize_image", "image_channels",
           "pool_smooth", "sobel", "fpga_responses"]

#: canonical names of the float family's single functions
GRAD_HIST = "waldboost_tpu.channels.grad_hist"
GRAD_MAG = "waldboost_tpu.channels.grad_mag"


def reflect_map(shape: Tuple[int, int],
                regions: Sequence[Tuple[int, int, int, int, int]]
                ) -> np.ndarray:
    """(H*W,) int64: the canvas position whose value each position holds
    after ``ops/warp.py::reflect_halos`` over ``regions`` (a vertical then
    a horizontal flip of ``min(halo, h, w)`` rows and columns per region,
    corners included), every other position its own."""
    H, W = shape
    idx = np.arange(H * W, dtype=np.int64).reshape(H, W)
    for y, x, h, w, halo in regions:
        if halo <= 0:
            continue
        b = min(halo, h, w)
        idx[y - b:y, x:x + w] = idx[y:y + b, x:x + w][::-1]
        idx[y + h:y + h + b, x:x + w] = idx[y + h - b:y + h, x:x + w][::-1]
        idx[y - b:y + h + b, x - b:x] = idx[y - b:y + h + b, x:x + b][:, ::-1]
        idx[y - b:y + h + b, x + w:x + w + b] = \
            idx[y - b:y + h + b, x + w - b:x + w][:, ::-1]
    return idx.reshape(-1)


@dataclasses.dataclass(frozen=True)
class ImageCanvasTables:
    """Host tables of the image-space resize, one entry per pixel of the
    flattened ``(H, W)`` image canvas.

    ``index`` (4, N) int32: the pixel's four corners as offsets into the
    flattened octave buffer, (row i0, col i0), (i0, i1), (i1, i0), (i1,
    i1); pixels outside every level and its reflected halo point at
    ``n_src``, one zero appended to the buffer.  uint8 frames: the row
    weight is ``fr / den_r`` and the column weight ``fc / den_c``, exact
    integers (``den = 2 * n_out``, so ``fr`` may equal ``den``); float
    frames: ``fh``/``fw`` are ``ops/warp.py::resize_taps``' float32
    fractions.  ``rmap`` is :func:`reflect_map` of the level regions
    (None without a reflect halo), ``oct_hw`` the octave shapes."""

    index: np.ndarray
    fr: np.ndarray
    den_r: np.ndarray
    fc: np.ndarray
    den_c: np.ndarray
    fh: np.ndarray
    fw: np.ndarray
    rmap: Optional[np.ndarray]
    n_src: int
    oct_hw: Tuple[Tuple[int, int], ...]
    canvas_hw: Tuple[int, int]


def _axis_taps(n_in: int, n_out: int):
    """``(i0, i1, num, den, frac32)`` of one axis: base and next source
    index, the exact fraction ``num / den`` (``den = 2 * n_out``) and its
    float32 rounding as ``ops/warp.py::resize_taps`` gives it."""
    i0, frac64 = resize_taps64(n_in, n_out)
    den = 2 * n_out
    k = np.arange(n_out, dtype=np.int64)
    c_num = np.clip((2 * k + 1) * n_in - n_out, 0, (n_in - 1) * den)
    num = c_num - i0.astype(np.int64) * den
    if not ((num >= 0) & (num <= den)).all():
        raise ValueError(f"resize {n_in}->{n_out}: inconsistent taps")
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, num, den, frac64.astype(np.float32)


def image_canvas_tables(packed: PackedPyramidPlan, halo: int,
                        image_hw: Tuple[int, int]) -> ImageCanvasTables:
    """The image-space canvas tables of ``image_hw`` frames in ``packed``
    with a reflect ``halo`` (``packed.halo`` for reflect-boundary channel
    functions, 0 for the FPGA family)."""
    H, W = packed.image_canvas_shape()
    s = packed.shrink
    N = H * W
    n_oct = max((pl.level.octave for pl in packed.levels), default=-1) + 1
    oct_hw, oct_off, n_src = _octave_layout(image_hw, n_oct)
    if n_src >= 2 ** 31:
        raise ValueError("octave buffer exceeds int32 offsets")
    lvl = np.full(N, -1, np.int32)
    lr = np.zeros(N, np.int64)
    lc = np.zeros(N, np.int64)
    for li, pl in enumerate(packed.levels):
        y, x, h, w = pl.y * s, pl.x * s, pl.level.height, pl.level.width
        pos = (np.arange(y, y + h)[:, None] * W
               + np.arange(x, x + w)[None, :]).ravel()
        lvl[pos] = li
        lr[pos] = np.repeat(np.arange(h), w)
        lc[pos] = np.tile(np.arange(w), h)
    regions = tuple((y, x, h, w, halo) for y, x, h, w, _ in
                    packed.reflect_regions()) if halo > 0 else ()
    rmap = reflect_map((H, W), regions) if regions else None
    src = rmap if rmap is not None else np.arange(N)
    L, R, C = lvl[src], lr[src], lc[src]
    index = np.full((4, N), n_src, np.int32)
    fr = np.zeros(N, np.int32)
    fc = np.zeros(N, np.int32)
    den_r = np.ones(N, np.int32)
    den_c = np.ones(N, np.int32)
    fh = np.zeros(N, np.float32)
    fw = np.zeros(N, np.float32)
    for li, pl in enumerate(packed.levels):
        sel = np.flatnonzero(L == li)
        r, c = R[sel], C[sel]
        oh, ow = oct_hw[pl.level.octave]
        i0r, i1r, nr, dr, f32r = _axis_taps(oh, pl.level.height)
        i0c, i1c, nc, dc, f32c = _axis_taps(ow, pl.level.width)
        rows = (i0r[r].astype(np.int64), i1r[r].astype(np.int64))
        cols = (i0c[c].astype(np.int64), i1c[c].astype(np.int64))
        for k in range(4):
            index[k, sel] = oct_off[pl.level.octave] + rows[k >> 1] * ow \
                + cols[k & 1]
        fr[sel], fc[sel] = nr[r], nc[c]
        den_r[sel], den_c[sel] = dr, dc
        fh[sel], fw[sel] = f32r[r], f32c[c]
    return ImageCanvasTables(index=index, fr=fr, den_r=den_r, fc=fc,
                             den_c=den_c, fh=fh, fw=fw, rmap=rmap,
                             n_src=n_src, oct_hw=tuple(oct_hw),
                             canvas_hw=(H, W))


@dataclasses.dataclass(frozen=True)
class ImageCanvasOperands:
    """:class:`ImageCanvasTables` of one frame type on a device: uint8
    frames the corner weights ``w00 .. w11`` (int32) and their
    denominator ``den`` (int64), float frames ``fh``, ``fw`` and the
    float32 ``1 - fh``, ``1 - fw``."""

    host: ImageCanvasTables
    index: torch.Tensor
    weights: Tuple[torch.Tensor, ...]
    den: Optional[torch.Tensor]

    @staticmethod
    def build(tables: ImageCanvasTables, device, exact: bool
              ) -> "ImageCanvasOperands":
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        if exact:
            fr, fc = t(tables.fr), t(tables.fc)
            wr0, wc0 = t(tables.den_r) - fr, t(tables.den_c) - fc
            weights = (wr0, fr, wc0, fc)
            den = t(tables.den_r).long() * t(tables.den_c).long()
        else:
            fh, fw = t(tables.fh), t(tables.fw)
            weights = (1.0 - fh, fh, 1.0 - fw, fw)  # float32, as JAX
            den = None
        return ImageCanvasOperands(tables, t(tables.index), weights, den)


def resize_image(octs: torch.Tensor, ops: ImageCanvasOperands
                 ) -> torch.Tensor:
    """(B, H, W) float32 image canvas of a (B, S) octave buffer (uint8:
    the exact floor ``floor(sum(w_r * w_c * g) / (den_r * den_c))``;
    float32: ``(left * (1 - fw) + right * fw)`` of the row lerps ``g0 * (1
    - fh) + g1 * fh``, each operation rounded on its own)."""
    if octs.dim() != 2 or octs.shape[1] != ops.host.n_src:
        raise ValueError(f"resize_image: octaves must be (B, "
                         f"{ops.host.n_src})")
    B = octs.shape[0]
    exact = ops.den is not None
    if exact != (octs.dtype == torch.uint8):
        raise ValueError("resize_image: the operands are for another frame "
                         "type")
    src = torch.nn.functional.pad(
        octs.to(torch.int32) if exact else octs, (0, 1))  # the gaps' zero
    g00, g01, g10, g11 = (src.index_select(1, ops.index[k])
                          for k in range(4))
    a0, a1, b0, b1 = ops.weights
    if exact:
        left = a0 * g00 + a1 * g10                   # < 255 * den_r: int32
        right = a0 * g01 + a1 * g11
        num = b0.long() * left + b1.long() * right
        out = torch.div(num, ops.den, rounding_mode="floor").to(
            torch.float32)
    else:
        left = g00 * a0 + g10 * a1
        right = g01 * a0 + g11 * a1
        out = left * b0 + right * b1
    return out.view((B,) + tuple(ops.host.canvas_hw))


#: grad_mag's normalisation: triangle radius and epsilon
NORM, EPS = 5, 1e-3


def _triangle(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The radius-5 triangle filter along ``dim``, symmetric-reflect
    edges, summed in float64 as scipy's symmetric correlation (centre tap,
    then ``(x[i-j] + x[i+j]) * w[j]`` for j = 5 .. 1) and rounded once."""
    w = [float(v) for v in triangle_kernel(NORM)[NORM:]]  # centre outwards
    xp = pad_reflect(x, NORM, dim).double()
    tap = lambda j: taps(xp, dim, NORM + j, NORM - j)
    out = tap(0) * w[0]
    for j in range(NORM, 0, -1):
        out = out + (tap(-j) + tap(j)) * w[j]
    return out.to(torch.float32)


def _grad_mag(gx: torch.Tensor, gy: torch.Tensor,
              rmap: torch.Tensor) -> torch.Tensor:
    # sqrt in float64, then one rounding: the correctly rounded float32
    # root (torch's float32 sqrt on the CPU is not)
    mag = torch.sqrt((gx * gx + gy * gy).double()).to(torch.float32)
    B, H, W = mag.shape
    mag_r = mag.reshape(B, H * W).index_select(1, rmap).view(B, H, W)
    nrm = _triangle(_triangle(mag_r, -2), -1)
    return (mag / (nrm + EPS))[:, None]


def sobel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 (dx, dy) of (..., H, W) images truncated to int32, zero on the
    border (``waldboost_tpu/fpga/channels.py::_sobel_int32``)."""
    xi = x.to(torch.int32)
    dxr = xi[..., :, 2:] - xi[..., :, :-2]
    dx = dxr[..., :-2, :] + 2 * dxr[..., 1:-1, :] + dxr[..., 2:, :]
    dyc = xi[..., 2:, :] - xi[..., :-2, :]
    dy = dyc[..., :, :-2] + 2 * dyc[..., :, 1:-1] + dyc[..., :, 2:]
    pad = lambda t: torch.nn.functional.pad(t, (1, 1, 1, 1))
    return pad(dx), pad(dy)


def fpga_responses(kind: str, dx: torch.Tensor, dy: torch.Tensor
                   ) -> torch.Tensor:
    """(..., C, H, W) int32 ``min(|r| // 4, 255)`` of each response of an
    FPGA kind to :func:`sobel`'s gradients; the half-integer orientations
    truncate toward zero."""
    if kind == "grad_hist_4_u1":
        rs = [dx, torch.div(dx - dy, 2, rounding_mode="trunc"), dy,
              torch.div(dx + dy, 2, rounding_mode="trunc")]
    elif kind == "grad_mag_u1":
        rs = [torch.maximum(dx.abs(), dy.abs())]
    else:
        raise ValueError(f"unknown FPGA kind {kind!r}")
    return torch.stack([torch.clamp(r.abs() // 4, max=255) for r in rs],
                       dim=-3)


def image_channels(x: torch.Tensor, cf: ChannelFunction,
                   rmap: Optional[torch.Tensor],
                   border: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, C, H, W) channels of a (B, H, W) float32 image canvas: each of
    ``cf``'s single functions in channel order, float32 (the FPGA kinds
    integer-valued).  ``rmap`` is the device :func:`reflect_map` (grad_mag),
    ``border`` the (H, W) bool stencil border mask (FPGA kinds)."""
    grads = None
    outs = []
    for name in cf.leaves():
        kind = resolve_channel_function(name).fused_kind
        if kind is not None:
            grads = grads or sobel(x)
            q = fpga_responses(kind, *grads)
            outs.append(torch.where(border, q, torch.zeros_like(q))
                        .to(torch.float32))
        elif name == GRAD_HIST:
            outs.append(project_bins(*gradients(x, float_dd=True)))
        elif name == GRAD_MAG:
            outs.append(_grad_mag(*gradients(x), rmap))
        else:
            raise ValueError(f"no image-space canvas for {name!r}")
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def pool_smooth(chns: torch.Tensor, shrink: int, smooth: int,
                interior: Optional[torch.Tensor],
                integer: bool) -> torch.Tensor:
    """The 2x2 average pool at ``shrink == 2`` (``((TL + BL) + TR) + BR``
    over 4, odd edges dropped), then at ``smooth == 1`` the 3x3/16 smooth
    (``integer``: truncated, as the reference's uint8 channels are), 0 off
    the ``interior`` mask, of (B, C, H, W) float32 channels."""
    if shrink == 2:
        chns = avg_pool_2(chns)
    if smooth == 1:
        v = smooth_3x3(chns)
        if integer:
            v = torch.floor(v)
        chns = torch.where(interior, v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))
    return chns.contiguous()
