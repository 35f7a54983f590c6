"""Kernel B2: the pooled grad_hist channel canvas from polyphase planes.

Counterpart of ``waldboost_tpu/ops/channels_pallas.py::
grad_hist_poly_pallas`` for uint8 content.  The CUDA kernel is
``csrc/grad_hist.cu``; :func:`grad_hist_plain` is the same chain in torch
with shifted adds (no ``conv2d``: cuDNN would run it in TF32).  A CPU
tensor takes the plain version, a CUDA tensor the kernel.

Values: ``f32(f64(gx*cos - gy*sin))`` per bin and phase with cos/sin of
``np.linspace(0, pi, 5)[:-1]`` computed by numpy on the host, ``abs``, the
2x2 pool ``(((TL + BL) + TR) + BR) * 0.25``, and with ``smooth == 1`` the
3x3/16 smooth in the reference's 9-term order and the interior-mask select.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .._build import check, load_library

__all__ = ["N_BINS", "grad_hist", "grad_hist_plain"]

N_BINS = 4
_THETA = np.linspace(0, np.pi, N_BINS + 1)[:-1]
COS = tuple(float(v) for v in np.cos(_THETA))
SIN = tuple(float(v) for v in np.sin(_THETA))

#: kernel launches made by :func:`grad_hist`
grad_hist_launches = 0


def _check(planes: torch.Tensor, mask: Optional[torch.Tensor],
           smooth: int) -> None:
    if planes.dtype != torch.uint8 or planes.dim() != 5 \
            or tuple(planes.shape[1:3]) != (2, 2):
        raise ValueError("grad_hist: planes must be (B, 2, 2, H, W) uint8")
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


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_DBL4 = ctypes.c_double * N_BINS
_COS4, _SIN4 = _DBL4(*COS), _DBL4(*SIN)


def _entry():
    fn = load_library("grad_hist").wb_grad_hist
    if fn.argtypes is None:
        # planes, mask, out, B, H, W, smooth, cos, sin, stream
        fn.argtypes = [_VP, _VP, _VP, _CI, _CI, _CI, _CI,
                       ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double), _VP]
        fn.restype = ctypes.c_int
    return fn


def grad_hist(planes: torch.Tensor, mask: Optional[torch.Tensor],
              smooth: int) -> torch.Tensor:
    """(B, 4, H, W) float32 channel canvas of (B, 2, 2, H, W) uint8 planes.
    ``mask`` (H, W) uint8 is the smooth interior mask (``smooth == 1``)."""
    _check(planes, mask, smooth)
    if planes.device.type == "cpu":
        return grad_hist_plain(planes, mask, smooth)
    if planes.device.type != "cuda":
        raise ValueError(f"grad_hist: unsupported device {planes.device}")
    global grad_hist_launches
    B, _, _, H, W = planes.shape
    out = torch.empty((B, N_BINS, H, W), dtype=torch.float32,
                      device=planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        err = _entry()(planes.data_ptr(),
                       mask.data_ptr() if smooth == 1 else None,
                       out.data_ptr(), B, H, W, smooth, _COS4, _SIN4, stream)
    check(err, "grad_hist kernel")
    grad_hist_launches += 1
    return out


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


def grad_hist_plain(planes: torch.Tensor, mask: Optional[torch.Tensor],
                    smooth: int) -> torch.Tensor:
    """Plain-torch version of the grad_hist kernel."""
    _check(planes, mask, smooth)
    P = planes.to(torch.int32)
    P = [[P[:, 0, 0], P[:, 0, 1]], [P[:, 1, 0], P[:, 1, 1]]]

    def tap3(a, b, c):
        return a + 2 * b + c

    sx = [[tap3(_shift(P[a][1], 0, -1), P[a][0], P[a][1]),
           tap3(P[a][0], P[a][1], _shift(P[a][0], 0, +1))] for a in (0, 1)]
    gy = [[_shift(sx[1][b], -1, 0) - sx[1][b] for b in (0, 1)],
          [sx[0][b] - _shift(sx[0][b], +1, 0) for b in (0, 1)]]
    sy = [[tap3(_shift(P[1][b], -1, 0), P[0][b], P[1][b]) for b in (0, 1)],
          [tap3(P[0][b], P[1][b], _shift(P[0][b], +1, 0)) for b in (0, 1)]]
    gx = [[_shift(sy[a][1], 0, -1) - sy[a][1],
           sy[a][0] - _shift(sy[a][0], 0, +1)] for a in (0, 1)]
    gx = [[g.to(torch.float64) for g in row] for row in gx]
    gy = [[g.to(torch.float64) for g in row] for row in gy]

    chans = []
    for k in range(N_BINS):
        v = [[(gx[a][b] * COS[k] - gy[a][b] * SIN[k]).to(torch.float32).abs()
              for b in (0, 1)] for a in (0, 1)]
        pooled = (((v[0][0] + v[1][0]) + v[0][1]) + v[1][1]) * 0.25
        if smooth == 1:
            pat = lambda dr, dc: _shift(pooled, dr, dc)
            s = pat(-1, -1) + 2.0 * pat(-1, 0) + pat(-1, 1) \
                + 2.0 * pat(0, -1) + 4.0 * pooled + 2.0 * pat(0, 1) \
                + pat(1, -1) + 2.0 * pat(1, 0) + pat(1, 1)
            pooled = torch.where(mask.bool(), s * (1.0 / 16.0),
                                 torch.zeros((), dtype=torch.float32,
                                             device=planes.device))
        chans.append(pooled)
    return torch.stack(chans, dim=1).contiguous()
