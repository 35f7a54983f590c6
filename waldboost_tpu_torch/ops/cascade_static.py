"""Kernels B3 and B4: the frozen cascade over every window origin.

Counterpart of ``waldboost_tpu/ops/cascade_static.py`` (``StaticCascade``,
``static_cascade_from_model``, ``cascade_masked_grid_static`` and
``cascade_response_grid_static``).  Both kernels live in
``csrc/cascade.cu``; each has a plain-torch version here that evaluates
the same cascade in lockstep over all windows
(:func:`~waldboost_tpu_torch.ops.cascade.lockstep`).  A CPU tensor takes
the plain version, a CUDA tensor the kernel.

Per window origin ``(r, c)`` of the ``(H - m, W - n)`` grid that is set in
the valid mask, and per stage in order: the depth-limited tree reads
``canvas[ch, r + fr, c + fc] <= thr`` from node 0 until a leaf (``left <
0``), ``hs += leaf`` in f32 from 0, and the window is rejected when the
stage's theta is finite and ``hs < theta``.  ``n_weak`` counts the stages
each window entered alive.

* B3, :func:`cascade_masked`: ``hs`` where the window survived, -inf
  elsewhere, and per-image survivor counts.
* B4, :func:`cascade_response`: the unmasked ``(hs, alive, n_weak)`` over
  the first ``n_stages_cap`` stages.  A rejected window keeps the ``hs`` of
  the stage it died in; an origin outside the mask keeps 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import check, load_library
from .cascade import NODE_KEYS, check_children, lockstep, stage_tables

__all__ = ["StaticCascade", "static_cascade_from_model", "CascadeOperands",
           "cascade_masked", "cascade_masked_plain", "cascade_response",
           "cascade_response_plain"]

#: kernel launches made by :func:`cascade_masked` (B3)
cascade_launches = 0
#: kernel launches made by :func:`cascade_response` (B4)
cascade_response_launches = 0


class StaticCascade:
    """Unpadded ``(T, NN)`` node tables of a frozen cascade, in the model
    file's node order, plus ``theta``."""

    def __init__(self, fr, fc, fch, thr, left, right, pred, theta):
        self.fr = np.asarray(fr, np.int32)
        self.fc = np.asarray(fc, np.int32)
        self.fch = np.asarray(fch, np.int32)
        self.thr = np.asarray(thr, np.float32)
        self.left = np.asarray(left, np.int32)
        self.right = np.asarray(right, np.int32)
        self.pred = np.asarray(pred, np.float32)
        self.theta = np.asarray(theta, np.float32)

    @property
    def n_stages(self) -> int:
        return self.fr.shape[0]


def static_cascade_from_model(model) -> StaticCascade:
    """Node tables of a model's stages (``model.stages``: dicts of
    ``feature`` (k, 3), ``threshold``, ``left``, ``right``, ``prediction``)."""
    tab = stage_tables(model.stages)
    theta = np.asarray(model.theta, np.float32) if model.stages \
        else np.zeros(0, np.float32)
    return StaticCascade(*(tab[k] for k in NODE_KEYS), theta)


@dataclasses.dataclass(frozen=True)
class CascadeOperands:
    """A :class:`StaticCascade` checked against its window and channel
    count and moved to a device.  ``theta`` is -inf where the stage does
    not reject (non-finite theta)."""

    sc: StaticCascade
    window: Tuple[int, int]
    n_channels: int
    fr: torch.Tensor
    fc: torch.Tensor
    fch: torch.Tensor
    thr: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    pred: torch.Tensor
    theta: torch.Tensor

    @staticmethod
    def build(sc: StaticCascade, window: Tuple[int, int], n_channels: int,
              device) -> "CascadeOperands":
        m, n = window
        inner = check_children(sc.left, sc.right)
        if np.any(inner & ((sc.fr < 0) | (sc.fr >= m) | (sc.fc < 0)
                           | (sc.fc >= n) | (sc.fch < 0)
                           | (sc.fch >= n_channels))):
            raise ValueError("cascade feature outside the window")
        theta = np.where(np.isfinite(sc.theta), sc.theta,
                         -np.inf).astype(np.float32)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        return CascadeOperands(sc, (m, n), n_channels, t(sc.fr), t(sc.fc),
                               t(sc.fch), t(sc.thr), t(sc.left), t(sc.right),
                               t(sc.pred), t(theta))

    @property
    def device(self) -> torch.device:
        return self.fr.device

    @property
    def tables(self):
        return [self.fr, self.fc, self.fch, self.thr, self.left, self.right,
                self.pred]

    def plain_theta(self) -> Sequence[float]:
        return np.where(np.isfinite(self.sc.theta), self.sc.theta,
                        -np.inf).tolist()


def _check(canvas: torch.Tensor, valid: torch.Tensor,
           ops: CascadeOperands) -> Tuple[int, int]:
    if canvas.dtype != torch.float32 or canvas.dim() != 4 \
            or canvas.shape[1] != ops.n_channels:
        raise ValueError(f"cascade: canvas must be (B, {ops.n_channels}, H, "
                         "W) float32")
    if not canvas.is_contiguous():
        raise ValueError("cascade: canvas must be contiguous")
    m, n = ops.window
    gu, gv = max(canvas.shape[2] - m, 0), max(canvas.shape[3] - n, 0)
    if valid.dtype != torch.uint8 or tuple(valid.shape) != (gu, gv) \
            or not valid.is_contiguous():
        raise ValueError(f"cascade: valid mask must be a contiguous "
                         f"({gu}, {gv}) uint8 tensor")
    if not canvas.device == valid.device == ops.device:
        raise ValueError("cascade: canvas, mask and tables on different "
                         "devices")
    return gu, gv


_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _entry(name: str):
    fn = getattr(load_library("cascade"), name)
    if fn.argtypes is None:
        # canvas, B, C, H, W, valid, gu, gv, 7 node tables, theta,
        # [active,] T, NN, 3 outputs, stream
        extra = [_VP] if name == "wb_cascade_generic" else []
        fn.argtypes = [_VP, _CI, _CI, _CI, _CI, _VP, _CI, _CI] + [_VP] * 8 \
            + extra + [_CI, _CI, _VP, _VP, _VP, _VP]
        fn.restype = ctypes.c_int
    return fn


def launch_response(name: str, canvas: torch.Tensor, valid: torch.Tensor,
                    tables, theta: torch.Tensor, n_stages: int, out0, out1,
                    n_weak, active: Optional[torch.Tensor] = None) -> None:
    """Launch one of the C entry points of ``csrc/cascade.cu`` on the
    current stream: ``wb_cascade`` (B3: outputs masked, count, n_weak),
    ``wb_cascade_response`` (B4) or ``wb_cascade_generic`` (B6, with
    ``active``) (outputs hs, alive, n_weak)."""
    B, C, H, W = canvas.shape
    gu, gv = valid.shape
    NN = tables[0].shape[1]
    ptrs = [t.data_ptr() for t in tables] + [theta.data_ptr()]
    if active is not None:
        ptrs.append(active.data_ptr())
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    with torch.cuda.device(canvas.device):
        err = _entry(name)(canvas.data_ptr(), B, C, H, W, valid.data_ptr(),
                           gu, gv, *ptrs, n_stages, NN, out0.data_ptr(),
                           out1.data_ptr(), n_weak.data_ptr(), stream)
    check(err, f"{name} kernel")


def _device_kind(canvas: torch.Tensor) -> str:
    kind = canvas.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"cascade: unsupported device {canvas.device}")
    return kind


def cascade_masked(canvas: torch.Tensor, valid: torch.Tensor,
                   ops: CascadeOperands
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(masked, n_weak, count)``: the (B, H - m, W - n) float32 map of
    ``hs`` where the window survived and -inf elsewhere, and per-image
    int32 ``n_weak`` and survivor ``count``."""
    gu, gv = _check(canvas, valid, ops)
    if _device_kind(canvas) == "cpu":
        return cascade_masked_plain(canvas, valid, ops)
    global cascade_launches
    B, dev = canvas.shape[0], canvas.device
    masked = torch.empty((B, gu, gv), dtype=torch.float32, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    n_weak = torch.zeros(B, dtype=torch.int32, device=dev)
    if B and gu and gv:
        launch_response("wb_cascade", canvas, valid, ops.tables, ops.theta,
                        ops.sc.n_stages, masked, count, n_weak)
        cascade_launches += 1
    return masked, n_weak, count


def cascade_masked_plain(canvas: torch.Tensor, valid: torch.Tensor,
                         ops: CascadeOperands
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch version of :func:`cascade_masked` (kernel B3)."""
    _check(canvas, valid, ops)
    hs, alive, n_weak, _ = lockstep(canvas, valid, vars(ops.sc),
                                    ops.plain_theta(), ops.sc.n_stages)
    masked = torch.where(alive, hs, torch.tensor(float("-inf"),
                                                 device=canvas.device))
    return masked, n_weak, alive.sum(dim=(1, 2)).to(torch.int32)


def _n_run(ops: CascadeOperands, n_stages_cap: Optional[int]) -> int:
    T = ops.sc.n_stages
    return T if n_stages_cap is None else max(min(T, int(n_stages_cap)), 0)


def cascade_response(canvas: torch.Tensor, valid: torch.Tensor,
                     ops: CascadeOperands, n_stages_cap: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hs, alive, n_weak)`` of the first ``n_stages_cap`` stages (all
    when None) at every window origin: (B, H - m, W - n) float32 and bool,
    and per-image int32 ``n_weak``."""
    gu, gv = _check(canvas, valid, ops)
    if _device_kind(canvas) == "cpu":
        return cascade_response_plain(canvas, valid, ops, n_stages_cap)
    global cascade_response_launches
    B, dev = canvas.shape[0], canvas.device
    hs = torch.zeros((B, gu, gv), dtype=torch.float32, device=dev)
    alive = torch.zeros((B, gu, gv), dtype=torch.bool, device=dev)
    n_weak = torch.zeros(B, dtype=torch.int32, device=dev)
    if B and gu and gv:
        launch_response("wb_cascade_response", canvas, valid, ops.tables,
                        ops.theta, _n_run(ops, n_stages_cap), hs, alive,
                        n_weak)
        cascade_response_launches += 1
    return hs, alive, n_weak


def cascade_response_plain(canvas: torch.Tensor, valid: torch.Tensor,
                           ops: CascadeOperands,
                           n_stages_cap: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch version of :func:`cascade_response` (kernel B4)."""
    _check(canvas, valid, ops)
    hs, alive, n_weak, _ = lockstep(canvas, valid, vars(ops.sc),
                                    ops.plain_theta(),
                                    _n_run(ops, n_stages_cap))
    return hs, alive, n_weak
