"""Kernel B1: every pyramid level resized into the polyphase plane canvas.

Counterpart of ``waldboost_tpu/polyphase_fused.py::_poly_planes_fused``
(pass-1 einsums + ``ops/plane_pallas.py::shelf_pass2_call``).  The CUDA
kernel is ``csrc/planes.cu``; :func:`planes_plain` is the same formula in
torch indexing.  A CPU tensor takes the plain version, a CUDA tensor the
kernel.  Both write every byte of the canvas, the gaps between levels as
0, so the canvas needs no zero fill first.

:func:`planes_float` builds the planes of exact float32 frames,
:func:`planes_float_fast` those of fast serving mode.  JAX computes both
in XLA, outside any Pallas kernel (``waldboost_tpu/polyphase.py::
_poly_level_blocks``: ``_combine_block_dd`` emulates float64 in
double-float pairs, ``_combine_block_plain`` with ``fast=True``), and so
does the port: a handful of torch ops over the whole canvas, the exact
build in native float64 tensors (each operation rounded on its own, no
fused multiply-add), the reference's own arithmetic
(``tests/oracle.py::resize_bilinear``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .._build import entry, launch, on_card
from ..polyphase import META_COLS, FloatPlaneTables, PlaneTables

__all__ = ["PlaneOperands", "octave_buffer", "planes", "planes_plain",
           "FloatPlaneOperands", "planes_float", "planes_float_fast"]

@dataclasses.dataclass(frozen=True)
class PlaneOperands:
    """:class:`~waldboost_tpu_torch.polyphase.PlaneTables` on a device."""

    host: PlaneTables
    tiles: torch.Tensor
    pieces: torch.Tensor
    rtap: torch.Tensor
    ctap: torch.Tensor
    i0h: torch.Tensor
    frh: torch.Tensor
    i0w: torch.Tensor
    frw: torch.Tensor

    @staticmethod
    def build(tables: PlaneTables, device) -> "PlaneOperands":
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                      device=device)
        return PlaneOperands(tables, t(tables.tiles),
                             t(tables.pieces), t(tables.rtap),
                             t(tables.ctap), t(tables.i0h), t(tables.frh),
                             t(tables.i0w), t(tables.frw))

    @property
    def device(self) -> torch.device:
        return self.tiles.device


def octave_buffer(octaves: List[torch.Tensor]) -> torch.Tensor:
    """(B, sum of octave sizes): the octave images flattened and
    concatenated, the layout the plane builds gather from."""
    B = octaves[0].shape[0]
    return torch.cat([o.reshape(B, -1) for o in octaves], dim=1).contiguous()


def _check(octs: torch.Tensor, ops: PlaneOperands,
           out: Optional[torch.Tensor]) -> None:
    if octs.dtype != torch.uint8 or octs.dim() != 2:
        raise ValueError("planes: octaves must be a (B, S) uint8 tensor")
    need = sum(h * w for h, w in ops.host.oct_hw)
    if octs.shape[1] != need:
        raise ValueError(f"planes: octave buffer holds {octs.shape[1]} "
                         f"pixels per image, the tables need {need}")
    if octs.device != ops.device:
        raise ValueError("planes: octaves and tables on different devices")
    if not octs.is_contiguous():
        raise ValueError("planes: octave buffer must be contiguous")
    if out is not None:
        shape = (octs.shape[0], 2, 2) + tuple(ops.host.plane_hw)
        if out.dtype != torch.uint8 or tuple(out.shape) != shape \
                or not out.is_contiguous() or out.device != octs.device:
            raise ValueError(f"planes: out must be a contiguous {shape} "
                             "uint8 tensor beside the octaves")


_VP, _CI = ctypes.c_void_p, ctypes.c_int
#: octs, oct_stride, tiles, n_tiles, pieces, rtap, ctap, planes, batch, PH,
#: PW, tile rows, tile cols, stream
_ARGS = (_VP, ctypes.c_longlong, _VP, _CI, _VP, _VP, _VP, _VP, _CI, _CI, _CI,
         _CI, _CI, _VP)


def planes(octs: torch.Tensor, ops: PlaneOperands,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 2, 2, PH, PW) uint8 polyphase planes of every pyramid level,
    into ``out`` when given (every byte of it is written)."""
    _check(octs, ops, out)
    if not on_card(octs, "planes"):
        res = planes_plain(octs, ops)
        return res if out is None else out.copy_(res)
    B = octs.shape[0]
    PH, PW = ops.host.plane_hw
    if out is None:
        out = torch.empty((B, 2, 2, PH, PW), dtype=torch.uint8,
                          device=octs.device)
    launch("planes", entry("planes", "wb_planes", _ARGS), octs.device,
           octs.data_ptr(), octs.shape[1], ops.tiles.data_ptr(),
           ops.tiles.shape[0], ops.pieces.data_ptr(), ops.rtap.data_ptr(),
           ops.ctap.data_ptr(), out.data_ptr(), B, PH, PW, *ops.host.tile_hw)
    return out


def planes_plain(octs: torch.Tensor, ops: PlaneOperands) -> torch.Tensor:
    """Plain-torch version of the plane kernel (the same integer formula)."""
    _check(octs, ops, None)
    B = octs.shape[0]
    PH, PW = ops.host.plane_hw
    dev = octs.device
    out = torch.zeros((B, 2, 2, PH, PW), dtype=torch.uint8, device=dev)
    for row in ops.host.meta.tolist():
        m = dict(zip(META_COLS, row))
        oct_off, oh, ow = m["oct_off"], m["oh"], m["ow"]
        hq, wq, y0, x0 = m["hq"], m["wq"], m["y0"], m["x0"]
        dh, dw, th, tw = m["den_h"], m["den_w"], m["tap_h"], m["tap_w"]
        img = octs[:, oct_off:oct_off + oh * ow].reshape(B, oh, ow)
        img = img.to(torch.int32)
        r0 = ops.i0h[th:th + 2 * hq].view(2, hq, 1, 1).long()
        fr = ops.frh[th:th + 2 * hq].view(2, hq, 1, 1)
        c0 = ops.i0w[tw:tw + 2 * wq].view(1, 1, 2, wq).long()
        fc = ops.frw[tw:tw + 2 * wq].view(1, 1, 2, wq)
        r1 = torch.clamp(r0 + 1, max=oh - 1)
        c1 = torch.clamp(c0 + 1, max=ow - 1)
        # corners indexed (B, a, i, q, j)
        g00, g01 = img[:, r0, c0], img[:, r0, c1]
        g10, g11 = img[:, r1, c0], img[:, r1, c1]
        wr0 = dh - fr
        n = (dw - fc) * (wr0 * g00 + fr * g10) + fc * (wr0 * g01 + fr * g11)
        v = torch.div(n, dh * dw, rounding_mode="floor")
        out[:, :, :, y0:y0 + hq, x0:x0 + wq] = \
            v.permute(0, 1, 3, 2, 4).to(torch.uint8)
    return out


@dataclasses.dataclass(frozen=True)
class FloatPlaneOperands:
    """:class:`~waldboost_tpu_torch.polyphase.FloatPlaneTables` on a
    device."""

    host: FloatPlaneTables
    index: torch.Tensor
    fh: torch.Tensor
    fw: torch.Tensor
    fh64: torch.Tensor
    fw64: torch.Tensor

    @staticmethod
    def build(tables: FloatPlaneTables, device) -> "FloatPlaneOperands":
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        return FloatPlaneOperands(tables, t(tables.index), t(tables.fh),
                                  t(tables.fw), t(tables.fh64),
                                  t(tables.fw64))


def _check_float(octs: torch.Tensor, ops: FloatPlaneOperands,
                 what: str) -> None:
    if octs.dtype != torch.float32 or octs.dim() != 2 \
            or octs.shape[1] != ops.host.n_src:
        raise ValueError(f"{what}: octaves must be a (B, {ops.host.n_src}) "
                         "float32 tensor")
    if octs.device != ops.index.device:
        raise ValueError(f"{what}: octaves and tables on different devices")


def _corners(src: torch.Tensor, ops: FloatPlaneOperands):
    """Each plane element's four corners (row i0, col i0), (i0, i1),
    (i1, i0), (i1, i1) of a (B, n_src + 1) octave buffer."""
    return (src.index_select(1, ops.index[k]) for k in range(4))


def planes_float(octs: torch.Tensor, ops: FloatPlaneOperands) -> torch.Tensor:
    """(B, 2, 2, PH, PW) float32 planes of a (B, S) float32 octave buffer
    of exact float frames: per element the reference's float64 two-pass
    lerp, ``top*(1 - fr) + bot*fr`` down each of the two corner columns,
    then ``left*(1 - fc) + right*fc`` across them on the unrounded rows,
    and one float32 rounding."""
    _check_float(octs, ops, "planes_float")
    B = octs.shape[0]
    src = torch.nn.functional.pad(octs, (0, 1)).double()  # the gaps' zero
    g00, g01, g10, g11 = _corners(src, ops)
    fh, fw = ops.fh64, ops.fw64
    left = g00 * (1 - fh) + g10 * fh
    right = g01 * (1 - fh) + g11 * fh
    out = left * (1 - fw) + right * fw
    return out.to(torch.float32).view((B, 2, 2) + tuple(ops.host.plane_hw))


def planes_float_fast(octs: torch.Tensor, ops: FloatPlaneOperands,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """(B, 2, 2, PH, PW) planes of a (B, S) float32 octave buffer in fast
    serving mode: per element its four corners, the row lerps ``r_b = g0b
    + fh*(g1b - g0b)`` and ``r0 + fw*(r1 - r0)`` in f32, each operation
    rounded on its own.  ``out_dtype`` float32, or bfloat16: the octave
    values are rounded to bfloat16 (to nearest even) before the lerp and
    the result after it."""
    _check_float(octs, ops, "planes_float_fast")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("planes_float_fast: out_dtype is float32 or "
                         "bfloat16")
    B = octs.shape[0]
    src = torch.nn.functional.pad(octs, (0, 1))  # the gaps' zero
    if out_dtype == torch.bfloat16:
        src = src.to(torch.bfloat16).to(torch.float32)
    g00, g01, g10, g11 = _corners(src, ops)
    r0 = g00 + ops.fh * (g10 - g00)
    r1 = g01 + ops.fh * (g11 - g01)
    out = r0 + ops.fw * (r1 - r0)
    return out.view((B, 2, 2) + tuple(ops.host.plane_hw)).to(out_dtype)
