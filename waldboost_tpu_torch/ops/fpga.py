"""Kernel B5: the FPGA integer channel canvas from polyphase planes.

Counterpart of ``waldboost_tpu/ops/channels_pallas.py::fpga_poly_pallas``
(body ``_make_fpga_kernel``) and of the XLA chain it is held to
(``fpga/channels.py::_sobel_poly``, ``_fpga_poly_channels`` and the smooth
tail of ``polyphase._poly_channels``).  The CUDA kernel is
``csrc/fpga.cu``; :func:`fpga_channels_plain` is the same chain in torch
integer ops with shifted adds (no ``conv2d``: cuDNN would run it in TF32).
A CPU tensor takes the plain version, a CUDA tensor the kernel.

Per image-canvas pixel, every value an exact integer:

* Sobel with zero fill outside the canvas: ``dx`` (right minus left of
  the vertical [1,2,1]), ``dy`` (below minus above of the horizontal one);
* the kind's responses in part order: ``grad_hist_4_u1`` gives ``dx``,
  ``trunc((dx - dy) / 2)``, ``dy``, ``trunc((dx + dy) / 2)``;
  ``grad_mag_u1`` gives ``max(|dx|, |dy|)``;
* ``min(|r| >> 2, 255)``, then 0 where the ring mask is 0;
* the 2x2 pool with uint8 wraparound ``((q00 + q10) + (q01 + q11)) & 255``,
  then ``>> 2``;
* with ``smooth == 1`` the 3x3/16 smooth of the pooled canvas (pooled
  values outside the canvas read 0), ``>> 4``, then 0 outside the
  interior mask.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .._build import check, load_library
from .channels import _shift

__all__ = ["RESPONSES", "MAX_CHANNELS", "response_codes", "fpga_channels",
           "fpga_channels_plain"]

#: response codes of each FPGA kind, in channel order (csrc/fpga.cu)
RESPONSES = {"grad_hist_4_u1": (0, 1, 2, 3), "grad_mag_u1": (4,)}
#: most channels one launch computes (the kernel's code table)
MAX_CHANNELS = 16

#: kernel launches made by :func:`fpga_channels`
fpga_launches = 0


@functools.lru_cache(maxsize=None)
def response_codes(kind: str) -> Tuple[int, ...]:
    """Response codes of a kind or a ``"+"`` composite of kinds."""
    codes = []
    for part in kind.split("+"):
        if part not in RESPONSES:
            raise ValueError(f"fpga_channels: unknown kind {part!r}")
        codes += RESPONSES[part]
    if len(codes) > MAX_CHANNELS:
        raise ValueError(f"fpga_channels: {kind!r} has {len(codes)} "
                         f"channels, at most {MAX_CHANNELS} are supported")
    return tuple(codes)


def _check(planes: torch.Tensor, ring: torch.Tensor,
           interior: Optional[torch.Tensor], smooth: int) -> None:
    if planes.dtype != torch.uint8 or planes.dim() != 5 \
            or tuple(planes.shape[1:3]) != (2, 2):
        raise ValueError("fpga_channels: planes must be (B, 2, 2, H, W) uint8")
    hw = tuple(planes.shape[3:])
    if ring.dtype != torch.uint8 or tuple(ring.shape) != (2, 2) + hw:
        raise ValueError("fpga_channels: ring must be a (2, 2, H, W) uint8 "
                         "tensor")
    if smooth not in (0, 1):
        raise ValueError("fpga_channels: smooth must be 0 or 1")
    masks = [ring]
    if smooth == 1:
        if interior is None or interior.dtype != torch.uint8 \
                or tuple(interior.shape) != hw:
            raise ValueError("fpga_channels: smooth == 1 needs the (H, W) "
                             "uint8 interior mask")
        masks.append(interior)
    for t in [planes] + masks:
        if not t.is_contiguous():
            raise ValueError("fpga_channels: inputs must be contiguous")
        if t.device != planes.device:
            raise ValueError("fpga_channels: inputs on different devices")


def fpga_channels(planes: torch.Tensor, ring: torch.Tensor,
                  interior: Optional[torch.Tensor], kind: str,
                  smooth: int) -> torch.Tensor:
    """(B, C, H, W) float32 FPGA channel canvas, integers in [0, 255], of
    (B, 2, 2, H, W) uint8 planes; ``ring`` (2, 2, H, W) and ``interior``
    (H, W, ``smooth == 1`` only) are uint8 masks."""
    codes = response_codes(kind)
    _check(planes, ring, interior, smooth)
    if planes.device.type == "cpu":
        return fpga_channels_plain(planes, ring, interior, kind, smooth)
    if planes.device.type != "cuda":
        raise ValueError(f"fpga_channels: unsupported device {planes.device}")
    global fpga_launches
    B, _, _, H, W = planes.shape
    out = torch.empty((B, len(codes), H, W), dtype=torch.float32,
                      device=planes.device)
    lib = load_library("fpga")
    fn = lib.wb_fpga
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        err = fn(planes.data_ptr(), ring.data_ptr(),
                 interior.data_ptr() if smooth == 1 else None, out.data_ptr(),
                 B, H, W, smooth, (ctypes.c_int * len(codes))(*codes),
                 len(codes), stream)
    check(err, "fpga kernel")
    fpga_launches += 1
    return out


def _sobel(planes: torch.Tensor):
    """(dx, dy) int32 per phase ``[a][b]`` of (B, 2, 2, H, W) planes, in
    the term order of the JAX package's ``_sobel_poly``."""
    P = planes.to(torch.int32)
    P = [[P[:, 0, 0], P[:, 0, 1]], [P[:, 1, 0], P[:, 1, 1]]]
    sy = [[_shift(P[1][b], -1, 0) + 2 * P[0][b] + P[1][b] for b in (0, 1)],
          [P[0][b] + 2 * P[1][b] + _shift(P[0][b], +1, 0) for b in (0, 1)]]
    dx = [[sy[a][1] - _shift(sy[a][1], 0, -1),
           _shift(sy[a][0], 0, +1) - sy[a][0]] for a in (0, 1)]
    sx = [[_shift(P[a][1], 0, -1) + 2 * P[a][0] + P[a][1],
           P[a][0] + 2 * P[a][1] + _shift(P[a][0], 0, +1)] for a in (0, 1)]
    dy = [[sx[1][b] - _shift(sx[1][b], -1, 0) for b in (0, 1)],
          [_shift(sx[0][b], +1, 0) - sx[0][b] for b in (0, 1)]]
    return dx, dy


def _response(code: int, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    if code == 0:
        return dx
    if code == 1:
        return torch.div(dx - dy, 2, rounding_mode="trunc")
    if code == 2:
        return dy
    if code == 3:
        return torch.div(dx + dy, 2, rounding_mode="trunc")
    return torch.maximum(dx.abs(), dy.abs())


def fpga_channels_plain(planes: torch.Tensor, ring: torch.Tensor,
                        interior: Optional[torch.Tensor], kind: str,
                        smooth: int) -> torch.Tensor:
    """Plain-torch version of the FPGA channel kernel."""
    codes = response_codes(kind)
    _check(planes, ring, interior, smooth)
    dx, dy = _sobel(planes)
    keep = ring.bool()
    zero = torch.zeros((), dtype=torch.int32, device=planes.device)
    chans = []
    for code in codes:
        def q(a, b):
            r = _response(code, dx[a][b], dy[a][b])
            return torch.where(keep[a, b],
                               torch.clamp(r.abs() >> 2, max=255), zero)

        s = (q(0, 0) + q(1, 0)) + (q(0, 1) + q(1, 1))
        pooled = (s & 255) >> 2
        if smooth == 1:
            pat = lambda dr, dc: _shift(pooled, dr, dc)
            v = pat(-1, -1) + 2 * pat(-1, 0) + pat(-1, 1) \
                + 2 * pat(0, -1) + 4 * pooled + 2 * pat(0, 1) \
                + pat(1, -1) + 2 * pat(1, 0) + pat(1, 1)
            pooled = torch.where(interior.bool(), v >> 4, zero)
        chans.append(pooled.to(torch.float32))
    return torch.stack(chans, dim=1).contiguous()
