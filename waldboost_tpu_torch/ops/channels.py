"""Kernels B2, B2d and B2f: the pooled grad_hist channel canvas from
polyphase planes.

Counterpart of ``waldboost_tpu/ops/channels_pallas.py::
grad_hist_poly_pallas``: :func:`grad_hist` (B2) its exact uint8 variant,
:func:`grad_hist_float` (B2d) its ``float_dd`` variant for float32
planes, :func:`grad_hist_fast` (B2f) its ``fast=True`` variant.  The CUDA
kernels are ``csrc/grad_hist.cu`` (B2) and ``csrc/grad_hist_float.cu``
(B2d, B2f); :func:`grad_hist_plain`,
:func:`grad_hist_float_plain` and :func:`grad_hist_fast_plain` are the
same chains in torch with shifted adds (no ``conv2d``: cuDNN would run it
in TF32).  A CPU tensor takes the plain version, a CUDA tensor the kernel.

B2 values: ``f32(f64(gx*cos - gy*sin))`` per bin and phase with cos/sin of
``np.linspace(0, pi, 5)[:-1]`` computed by numpy on the host, ``abs``, the
2x2 pool ``(((TL + BL) + TR) + BR) * 0.25``, and with ``smooth == 1`` the
3x3/16 smooth in the reference's 9-term order and the interior-mask select.
B2d: B2's chain on float32 planes, each prefilter ``(a + 2b) + c`` summed
in float64 and rounded to float32 once (scipy's float64 accumulator), the
gradient differences in float32, each bin ``f32(f64(gx)*cos -
f64(gy)*sin)``.  B2f: every step in f32, each operation rounded on its
own (prefilters ``(a + 2b) + c`` and the gradients in f32 too), the
projection ``gx*f32(cos) - gy*f32(sin)``, and one round to bfloat16 at
the end.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .._build import entry, launch, on_card

__all__ = ["N_BINS", "project_bins", "grad_hist", "grad_hist_plain",
           "grad_hist_float", "grad_hist_float_plain", "grad_hist_fast",
           "grad_hist_fast_plain"]

N_BINS = 4
_THETA = np.linspace(0, np.pi, N_BINS + 1)[:-1]
COS = tuple(float(v) for v in np.cos(_THETA))
SIN = tuple(float(v) for v in np.sin(_THETA))
#: the f32 roundings B2f multiplies by (bin 2's cos is 6.1e-17, not 0)
COS32 = tuple(float(v) for v in np.cos(_THETA).astype(np.float32))
SIN32 = tuple(float(v) for v in np.sin(_THETA).astype(np.float32))

#: plane element types of B2f, and the byte count its C entry keys on
_FAST_TYPES = {torch.uint8: 1, torch.bfloat16: 2, torch.float32: 4}


def _check(planes: torch.Tensor, mask: Optional[torch.Tensor],
           smooth: int, types=(torch.uint8,)) -> None:
    if planes.dtype not in types or planes.dim() != 5 \
            or tuple(planes.shape[1:3]) != (2, 2):
        names = ", ".join(str(t).replace("torch.", "") for t in types)
        raise ValueError(f"grad_hist: planes must be (B, 2, 2, H, W) "
                         f"{names}")
    if not planes.is_contiguous():
        raise ValueError("grad_hist: planes must be contiguous")
    if smooth not in (0, 1):
        raise ValueError("grad_hist: smooth must be 0 or 1")
    if smooth == 1:
        if mask is None:
            raise ValueError("grad_hist: smooth == 1 needs the interior mask")
        if mask.dtype != torch.uint8 or tuple(mask.shape) != \
                tuple(planes.shape[3:]) or not mask.is_contiguous():
            raise ValueError("grad_hist: mask must be a contiguous (H, W) "
                             "uint8 tensor")
        if mask.device != planes.device:
            raise ValueError("grad_hist: planes and mask on different "
                             "devices")


def project_bins(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """grad_hist's (..., 4, H, W) float32 bins of (..., H, W) gradients:
    ``abs(f32(f64(gx)*cos - f64(gy)*sin))`` per bin."""
    gx, gy = gx.double(), gy.double()
    return torch.stack([(gx * COS[k] - gy * SIN[k]).to(torch.float32).abs()
                        for k in range(N_BINS)], dim=-3)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_DBL4 = ctypes.c_double * N_BINS
_COS4, _SIN4 = _DBL4(*COS), _DBL4(*SIN)
_DBL_P = ctypes.POINTER(ctypes.c_double)
#: planes, mask, out, B, H, W, smooth, [element bytes,] cos, sin, stream
_ARGS = (_VP, _VP, _VP, _CI, _CI, _CI, _CI)
_TAIL = (_DBL_P, _DBL_P, _VP)
#: each kernel's source and the signature of its C entry ``wb_<kernel>``
_ENTRIES = {"grad_hist": ("grad_hist", _ARGS + _TAIL),
            "grad_hist_float": ("grad_hist_float", _ARGS + _TAIL),
            "grad_hist_fast": ("grad_hist_float", _ARGS + (_CI,) + _TAIL)}


def _launch(kernel: str, planes: torch.Tensor, mask: Optional[torch.Tensor],
            smooth: int, dtype: torch.dtype, *extra,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, _, _, H, W = planes.shape
    shape = (B, N_BINS, H, W)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=planes.device)
    elif out.dtype != dtype or tuple(out.shape) != shape \
            or not out.is_contiguous() or out.device != planes.device:
        raise ValueError(f"grad_hist: out must be a contiguous {shape} "
                         f"{dtype} tensor beside the planes")
    source, argtypes = _ENTRIES[kernel]
    launch(kernel, entry(source, "wb_" + kernel, argtypes), planes.device,
           planes.data_ptr(), mask.data_ptr() if smooth == 1 else None,
           out.data_ptr(), B, H, W, smooth, *extra, _COS4, _SIN4)
    return out


def grad_hist(planes: torch.Tensor, mask: Optional[torch.Tensor],
              smooth: int) -> torch.Tensor:
    """(B, 4, H, W) float32 channel canvas of (B, 2, 2, H, W) uint8 planes.
    ``mask`` (H, W) uint8 is the smooth interior mask (``smooth == 1``)."""
    _check(planes, mask, smooth)
    if not on_card(planes, "grad_hist"):
        return grad_hist_plain(planes, mask, smooth)
    return _launch("grad_hist", planes, mask, smooth, torch.float32)


def grad_hist_float(planes: torch.Tensor, mask: Optional[torch.Tensor],
                    smooth: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 4, H, W) float32 channel canvas of exact float frames (B2d) from
    (B, 2, 2, H, W) float32 planes, into ``out`` when given (every element
    of it is written)."""
    _check(planes, mask, smooth, (torch.float32,))
    if not on_card(planes, "grad_hist"):
        res = grad_hist_float_plain(planes, mask, smooth)
        return res if out is None else out.copy_(res)
    return _launch("grad_hist_float", planes, mask, smooth, torch.float32,
                   out=out)


def grad_hist_fast(planes: torch.Tensor, mask: Optional[torch.Tensor],
                   smooth: int) -> torch.Tensor:
    """(B, 4, H, W) bfloat16 channel canvas of fast serving mode (B2f) from
    (B, 2, 2, H, W) uint8, bfloat16 or float32 planes."""
    _check(planes, mask, smooth, _FAST_TYPES)
    if not on_card(planes, "grad_hist"):
        return grad_hist_fast_plain(planes, mask, smooth)
    return _launch("grad_hist_fast", planes, mask, smooth, torch.bfloat16,
                   _FAST_TYPES[planes.dtype])


def _shift(p: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """``p[..., i + dr, j + dc]`` with zero fill, |dr|, |dc| <= 1."""
    out = torch.zeros_like(p)
    H, W = p.shape[-2:]
    rd = slice(max(-dr, 0), H - max(dr, 0))
    rs = slice(max(dr, 0), H - max(-dr, 0))
    cd = slice(max(-dc, 0), W - max(dc, 0))
    cs = slice(max(dc, 0), W - max(-dc, 0))
    out[..., rd, cd] = p[..., rs, cs]
    return out


def _gradients(P: torch.Tensor, wide: bool = False):
    """``(gx, gy)``, each ``[a][q]`` per phase, of (B, 2, 2, H, W) int32 or
    float32 planes, zero off the canvas: prefilters ``(a + 2b) + c``, gx
    left minus right of the vertical one, gy above minus below of the
    horizontal one, each operation rounded on its own; with ``wide`` each
    prefilter of float32 planes is summed in float64 and rounded once."""
    P = [[P[:, 0, 0], P[:, 0, 1]], [P[:, 1, 0], P[:, 1, 1]]]

    def tap3(a, b, c):
        if wide:
            a, b, c = a.double(), b.double(), c.double()
            return (a + 2 * b + c).to(torch.float32)
        return a + 2 * b + c

    sx = [[tap3(_shift(P[a][1], 0, -1), P[a][0], P[a][1]),
           tap3(P[a][0], P[a][1], _shift(P[a][0], 0, +1))] for a in (0, 1)]
    gy = [[_shift(sx[1][b], -1, 0) - sx[1][b] for b in (0, 1)],
          [sx[0][b] - _shift(sx[0][b], +1, 0) for b in (0, 1)]]
    sy = [[tap3(_shift(P[1][b], -1, 0), P[0][b], P[1][b]) for b in (0, 1)],
          [tap3(P[0][b], P[1][b], _shift(P[0][b], +1, 0)) for b in (0, 1)]]
    gx = [[_shift(sy[a][1], 0, -1) - sy[a][1],
           sy[a][0] - _shift(sy[a][0], 0, +1)] for a in (0, 1)]
    return gx, gy


def _pool_smooth(gx, gy, proj, mask: Optional[torch.Tensor],
                 smooth: int) -> torch.Tensor:
    """(B, 4, H, W) float32: per bin ``k`` the pool of ``proj(gx, gy, k)``
    over the four phases, then the smooth and the mask select."""
    chans = []
    for k in range(N_BINS):
        v = [[proj(gx[a][b], gy[a][b], k) for b in (0, 1)] for a in (0, 1)]
        pooled = (((v[0][0] + v[1][0]) + v[0][1]) + v[1][1]) * 0.25
        if smooth == 1:
            pat = lambda dr, dc: _shift(pooled, dr, dc)
            s = pat(-1, -1) + 2.0 * pat(-1, 0) + pat(-1, 1) \
                + 2.0 * pat(0, -1) + 4.0 * pooled + 2.0 * pat(0, 1) \
                + pat(1, -1) + 2.0 * pat(1, 0) + pat(1, 1)
            pooled = torch.where(mask.bool(), s * (1.0 / 16.0),
                                 torch.zeros((), dtype=torch.float32,
                                             device=pooled.device))
        chans.append(pooled)
    return torch.stack(chans, dim=1).contiguous()


def grad_hist_plain(planes: torch.Tensor, mask: Optional[torch.Tensor],
                    smooth: int) -> torch.Tensor:
    """Plain-torch version of the grad_hist kernel."""
    _check(planes, mask, smooth)
    gx, gy = _gradients(planes.to(torch.int32))
    gx = [[g.to(torch.float64) for g in row] for row in gx]
    gy = [[g.to(torch.float64) for g in row] for row in gy]
    return _pool_smooth(
        gx, gy, lambda x, y, k: (x * COS[k] - y * SIN[k]).to(torch.float32)
        .abs(), mask, smooth)


def grad_hist_float_plain(planes: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          smooth: int) -> torch.Tensor:
    """Plain-torch version of the exact-float grad_hist kernel (B2d)."""
    _check(planes, mask, smooth, (torch.float32,))
    gx, gy = _gradients(planes, wide=True)
    return _pool_smooth(
        gx, gy, lambda x, y, k: (x.double() * COS[k] - y.double() * SIN[k])
        .to(torch.float32).abs(), mask, smooth)


def grad_hist_fast_plain(planes: torch.Tensor, mask: Optional[torch.Tensor],
                         smooth: int) -> torch.Tensor:
    """Plain-torch version of the fast grad_hist kernel (B2f)."""
    _check(planes, mask, smooth, _FAST_TYPES)
    gx, gy = _gradients(planes.to(torch.float32))
    return _pool_smooth(gx, gy,
                        lambda x, y, k: (x * COS32[k] - y * SIN32[k]).abs(),
                        mask, smooth).to(torch.bfloat16)
