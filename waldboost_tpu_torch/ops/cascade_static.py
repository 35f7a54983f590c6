"""Kernels B3, B3f and B4: the frozen cascade over every window origin.

Counterpart of ``waldboost_tpu/ops/cascade_static.py`` (``StaticCascade``,
``static_cascade_from_model``, ``cascade_masked_grid_static`` and
``cascade_response_grid_static``).  B3 and B4 live in
``csrc/cascade.cu``, B3f in ``csrc/cascade_fast.cu``; each has a
plain-torch version here that evaluates
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
  elsewhere, and per-image survivor counts.  Over a bfloat16 canvas
  (fast serving mode) it is B3f (``cascade_masked_grid_static(fast=
  True)``): each canvas value widened to f32 at its read, so the results
  equal B3's over the canvas's float32 copy.  B3f runs a dense front over
  TMA-staged tiles of origins (the first stages, through
  ``ops/cascade.py::FRONT_REJECTS`` stages that can reject, from
  :meth:`CascadeOperands.front`'s records; from global memory where the
  canvas rows or base are off 16 bytes), then the walk for the
  survivors.
* B4, :func:`cascade_response`: the unmasked ``(hs, alive, n_weak)`` over
  the first ``n_stages_cap`` stages.  A rejected window keeps the ``hs`` of
  the stage it died in; an origin outside the mask keeps 0.  It takes a
  bfloat16 canvas too, read the same way.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import entry, launch, launches, load_library, on_card
from ..device import resolve_device
from .cascade import (NODE_KEYS, FrontRecords, NodeRecords, check_children,
                      front_records, launch_response, lockstep,
                      stage_tables)

__all__ = ["StaticCascade", "static_cascade_from_model", "CascadeOperands",
           "cascade_masked", "cascade_masked_plain", "cascade_response",
           "cascade_response_plain"]

#: the path of each front mode (``ops/cascade.py::FRONT_NONE``,
#: ``FRONT_STAGED``, ``FRONT_GLOBAL``)
FAST_PATHS = ("none", "tma", "global")


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


@dataclasses.dataclass(frozen=True, eq=False)
class CascadeOperands:
    """A :class:`StaticCascade` checked against its window and channel
    count, for one device.  ``theta`` is -inf where the stage does not
    reject (non-finite theta); :meth:`records` packs the tables for the
    kernels."""

    sc: StaticCascade
    window: Tuple[int, int]
    n_channels: int
    theta: np.ndarray
    device: torch.device

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
        return CascadeOperands(sc, (m, n), n_channels, theta,
                               resolve_device(device))

    @functools.cached_property
    def _records(self) -> dict:
        return {}

    def records(self, shape: Tuple[int, int, int]) -> NodeRecords:
        """The :func:`~waldboost_tpu_torch.ops.cascade.node_records` of the
        cascade for a (C, H, W) canvas on :attr:`device` (built once per
        shape); every stage counts toward n_weak."""
        if shape not in self._records:
            self._records[shape] = NodeRecords.build(
                vars(self.sc), self.theta, np.ones(self.sc.n_stages, bool),
                shape, self.device)
        return self._records[shape]

    @functools.cached_property
    def _fronts(self) -> dict:
        return {}

    def front(self, shape: Tuple[int, int, int], tile: Tuple[int, int],
              stageable: bool = True) -> "DeviceFront":
        """B3f's front records (:func:`~waldboost_tpu_torch.ops.cascade.
        front_records`) for a (C, H, W) canvas on :attr:`device` and the
        kernel's ``tile`` of origins, built once per shape, tile and
        ``stageable`` (the canvas rows and base on 16 bytes)."""
        key = (shape, tuple(tile), stageable)
        if key not in self._fronts:
            rec = front_records(vars(self.sc), self.theta,
                                np.ones(self.sc.n_stages, bool), shape,
                                self.window, tile, stageable)
            self._fronts[key] = DeviceFront(
                rec, torch.as_tensor(rec.data, device=self.device))
        return self._fronts[key]

    @functools.cached_property
    def _fast_runs(self) -> dict:
        return {}

    def plain_theta(self) -> Sequence[float]:
        return self.theta.tolist()


class DeviceFront(NamedTuple):
    """:class:`~waldboost_tpu_torch.ops.cascade.FrontRecords` and their
    records on a device."""
    rec: FrontRecords
    data: torch.Tensor


def _check(canvas: torch.Tensor, valid: torch.Tensor,
           ops: CascadeOperands) -> Tuple[int, int]:
    if canvas.dtype not in (torch.float32, torch.bfloat16) \
            or canvas.dim() != 4 or canvas.shape[1] != ops.n_channels:
        raise ValueError(f"cascade: canvas must be (B, {ops.n_channels}, H, "
                         "W) float32 or bfloat16")
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
#: canvas, B, valid, masked, sums; C, H, W, gu, gv, m, n, records, bytes,
#: layout, T, NN, front records, F, front mode; stream
_FAST_ARGS = (_VP, _CI, _VP, _VP, _VP) + (_CI,) * 7 + \
    (_VP, _CI, _CI, _CI, _CI, _VP, _CI, _CI, _VP)


def _fast_run(ops: CascadeOperands, key) -> tuple:
    """What every B3f launch at one canvas shape passes the same: the C
    entry, the arguments from C on, the front's path and the device
    tensors those arguments point into."""
    C, H, W, gu, gv, stageable = key
    fn = entry("cascade_fast", "wb_cascade_fast", _FAST_ARGS)
    rows, cols = _CI(), _CI()
    entry("cascade_fast", "wb_cascade_fast_tile",
          (ctypes.POINTER(_CI), ctypes.POINTER(_CI)), None)(
              ctypes.byref(rows), ctypes.byref(cols))
    rec = ops.records((C, H, W))
    front = ops.front((C, H, W), (rows.value, cols.value), stageable)
    fr = front.rec
    args = (C, H, W, gu, gv, *ops.window, rec.data.data_ptr(),
            rec.data.numel() * 4, rec.layout, ops.sc.n_stages,
            ops.sc.fr.shape[1], front.data.data_ptr(), fr.n_stages, fr.mode)
    return fn, args, FAST_PATHS[fr.mode], (rec.data, front.data)


def launch_fast(canvas: torch.Tensor, valid: torch.Tensor,
                ops: CascadeOperands, masked, sums) -> str:
    """Launch B3f (``wb_cascade_fast`` of ``csrc/cascade_fast.cu``) on the
    current stream over a bfloat16 canvas, into ``masked`` and ``sums``
    (2 x B int32: the count, then n_weak; zeroed by the launch); count it
    under ``cascade_fast`` and ``cascade_fast/<path>``, and return how
    its front read the canvas (the path, one of :data:`FAST_PATHS`).  The
    arguments of a canvas shape are made once (:func:`_fast_run`)."""
    B, C, H, W = canvas.shape
    lib = load_library("cascade_fast")
    key = (C, H, W, *valid.shape, W % 8 == 0 and canvas.data_ptr() % 16 == 0)
    run = ops._fast_runs.get((lib, key))
    if run is None:
        run = ops._fast_runs[(lib, key)] = _fast_run(ops, key)
    fn, args, path, _ = run
    launch("cascade_fast", fn, canvas.device, canvas.data_ptr(), B,
           valid.data_ptr(), masked.data_ptr(), sums.data_ptr(), *args)
    launches["cascade_fast/" + path] += 1
    return path


def cascade_masked(canvas: torch.Tensor, valid: torch.Tensor,
                   ops: CascadeOperands
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(masked, n_weak, count)``: the (B, H - m, W - n) float32 map of
    ``hs`` where the window survived and -inf elsewhere, and per-image
    int32 ``n_weak`` and survivor ``count``; B3f for a bfloat16 canvas."""
    gu, gv = _check(canvas, valid, ops)
    if not on_card(canvas, "cascade"):
        return cascade_masked_plain(canvas, valid, ops)
    B, dev = canvas.shape[0], canvas.device
    masked = torch.empty((B, gu, gv), dtype=torch.float32, device=dev)
    if canvas.dtype == torch.bfloat16 and B and gu and gv:
        sums = torch.empty((2, B), dtype=torch.int32, device=dev)
        launch_fast(canvas, valid, ops, masked, sums)
        return masked, sums[1], sums[0]
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    n_weak = torch.zeros(B, dtype=torch.int32, device=dev)
    if B and gu and gv:
        T = ops.sc.n_stages
        launch_response("cascade", canvas, valid,
                        ops.records(tuple(canvas.shape[1:])), T, T,
                        ops.sc.fr.shape[1], masked, count, n_weak)
    return masked, n_weak, count


def cascade_masked_plain(canvas: torch.Tensor, valid: torch.Tensor,
                         ops: CascadeOperands
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch version of :func:`cascade_masked` (kernels B3, B3f)."""
    _check(canvas, valid, ops)
    hs, alive, n_weak, _ = lockstep(canvas.float(), valid, vars(ops.sc),
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
    if not on_card(canvas, "cascade"):
        return cascade_response_plain(canvas, valid, ops, n_stages_cap)
    B, dev = canvas.shape[0], canvas.device
    hs = torch.empty((B, gu, gv), dtype=torch.float32, device=dev)
    alive = torch.empty((B, gu, gv), dtype=torch.bool, device=dev)
    n_weak = torch.zeros(B, dtype=torch.int32, device=dev)
    if B and gu and gv:
        launch_response("cascade_response", canvas, valid,
                        ops.records(tuple(canvas.shape[1:])), ops.sc.n_stages,
                        _n_run(ops, n_stages_cap), ops.sc.fr.shape[1], hs,
                        alive, n_weak)
    return hs, alive, n_weak


def cascade_response_plain(canvas: torch.Tensor, valid: torch.Tensor,
                           ops: CascadeOperands,
                           n_stages_cap: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch version of :func:`cascade_response` (kernel B4)."""
    _check(canvas, valid, ops)
    hs, alive, n_weak, _ = lockstep(canvas.float(), valid, vars(ops.sc),
                                    ops.plain_theta(),
                                    _n_run(ops, n_stages_cap))
    return hs, alive, n_weak
