"""Batched detection on the device.

Counterpart of ``waldboost_tpu/parallel/detect.py``:
``make_batched_detector`` (unmasked maps through kernel B4, with the
two-phase ``n_stages_cap``), ``make_batched_detector_boxes`` (its
one-program masked path), ``make_multi_detector_boxes`` and
``detect_batch``.  The main path for a (B, H, W) uint8 batch:

    canvas    octaves, planes (B1), channel canvas (B2 grad_hist, B5 FPGA)
              (canvas.py)
    cascade   frozen cascade, masked score map (kernel B3, ops/cascade_static.py)
    extract   exact top-k boxes and greedy NMS     (ops/nms.py, plain torch)

While a torch profiler runs, each step runs inside a ``record_function``
span named ``wb.<step>`` (``wb.octaves``, ``wb.planes``, ``wb.channels``,
``wb.cascade``, ``wb.extract``, ``wb.nms``), so a trace attributes host
and device time to the layers.

Every entry point runs on ``device``, or on the model's device when None
(which is the card unless the model was loaded or moved elsewhere).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..boxes import Boxes
from ..canvas import (as_image, channel_canvas, serving_opts, span,
                      window_grid)
from ..model import Model, shared_plan
from ..ops.cascade_static import cascade_masked, cascade_response
from ..ops.nms import extract_detections, nms
from ..packing import PackedPyramidPlan

__all__ = ["BatchedDetector", "make_batched_detector",
           "make_batched_detector_boxes", "make_multi_detector_boxes",
           "detect_batch", "span"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh serving is not ported yet "
                                  "(ROADMAP item A11)")


def _check_images(images, image_shape, device) -> int:
    h, w = image_shape
    if not isinstance(images, torch.Tensor):
        raise ValueError("images must be a torch tensor")
    if images.is_floating_point():
        raise NotImplementedError("float images are not ported yet "
                                  "(ROADMAP item A6)")
    if images.dtype != torch.uint8 or images.dim() != 3 \
            or tuple(images.shape[1:]) != (h, w):
        raise ValueError(f"images must be (B, {h}, {w}) uint8, got "
                         f"{tuple(images.shape)} {images.dtype}")
    if images.device != device:
        raise ValueError(f"images on {images.device}, detector built for "
                         f"{device}")
    return images.shape[0]


class BatchedDetector:
    """A model's serving tables on one device for one frame size.

    Calling it runs the whole path; ``canvas`` (the shared
    :class:`~waldboost_tpu_torch.canvas.ChannelCanvas`), :meth:`cascade`
    and :meth:`extract` expose each step at the main path's shapes.  Built
    by :func:`make_batched_detector_boxes`.
    """

    def __init__(self, model: Model, packed: PackedPyramidPlan,
                 image_shape: Tuple[int, int], k: int,
                 nms_iou: Optional[float], with_n_weak: bool,
                 device: torch.device):
        _, _, smooth, cf = serving_opts(model.channel_opts, model.shape[2])
        self.packed = packed
        self.image_shape = image_shape
        self.window = model.shape[:2]
        self.k = k
        self.nms_iou = nms_iou
        self.with_n_weak = with_n_weak
        self.device = device
        self.canvas = channel_canvas(packed, image_shape, smooth, cf, device)
        self.grid = window_grid(packed, self.window, device)
        self.cascade_ops = model._operands(device)

    def cascade(self, canvas: torch.Tensor):
        return cascade_masked(canvas, self.grid.valid, self.cascade_ops)

    def extract(self, masked: torch.Tensor, count: torch.Tensor):
        g = self.grid
        with span("wb.extract"):
            rects, scores, keep, count = extract_detections(
                masked, count, g.level_id, g.offsets, g.inv_scales,
                self.window, self.k)
        if self.nms_iou is not None:
            with span("wb.nms"):
                keep = keep & nms(rects, scores, keep, float(self.nms_iou))
        return rects, scores, keep, count

    def __call__(self, images: torch.Tensor):
        """``(rects, scores, valid, count, n_weak)`` of a (B, H, W) uint8
        batch; see :func:`make_batched_detector_boxes`."""
        B = _check_images(images, self.image_shape, self.device)
        if not self.packed.levels:
            z = lambda *s, dt: torch.zeros(s, dtype=dt, device=self.device)
            return (z(B, 0, 4, dt=torch.float32), z(B, 0, dt=torch.float32),
                    z(B, 0, dt=torch.bool), z(B, dt=torch.int32),
                    z(B, dt=torch.int32))
        canvas = self.canvas(images)
        with span("wb.cascade"):
            masked, n_weak, count = self.cascade(canvas)
        rects, scores, keep, count = self.extract(masked, count)
        if not self.with_n_weak:
            n_weak = torch.zeros_like(n_weak)
        return rects, scores, keep, count, n_weak


def make_batched_detector(model: Model, image_shape: Tuple[int, int],
                          n_stages_cap: Optional[int] = None, device=None,
                          mesh=None):
    """Build ``fn(images) -> (hs, alive, n_weak)`` for ``image_shape``
    frames: the (B, GU, GV) float32 and bool maps and per-image int32
    ``n_weak`` of the first ``n_stages_cap`` stages (all when None) over
    the packed canvas (kernels B1, B2 or B5, B4).  Returns ``(fn,
    packed)``."""
    _no_mesh(mesh)
    h, w = (int(s) for s in image_shape)
    dev = model._device_for(device)
    packed, smooth, cf = model._plan((h, w))
    grid = window_grid(packed, model.shape[:2], dev)
    canvas = channel_canvas(packed, (h, w), smooth, cf, dev)
    ops = model._operands(dev)

    def fn(images: torch.Tensor):
        B = _check_images(images, (h, w), dev)
        if not packed.levels:
            gu, gv = grid.valid.shape
            return (torch.zeros((B, gu, gv), dtype=torch.float32, device=dev),
                    torch.zeros((B, gu, gv), dtype=torch.bool, device=dev),
                    torch.zeros(B, dtype=torch.int32, device=dev))
        cv = canvas(images)
        with span("wb.cascade"):
            return cascade_response(cv, grid.valid, ops, n_stages_cap)

    return fn, packed


def make_batched_detector_boxes(model: Model, image_shape: Tuple[int, int],
                                k: int = 1024,
                                nms_iou: Optional[float] = None,
                                with_n_weak: bool = True,
                                device=None, mesh=None,
                                two_phase: bool = False,
                                n_scales: Optional[int] = None,
                                fast: bool = False):
    """Build a batched detector for ``model`` on ``image_shape`` frames.

    Returns ``(fn, packed)``; ``fn(images)`` takes a (B, H, W) uint8 tensor
    on the detector's device and returns ``(rects, scores, valid, count,
    n_weak)``: per image the ``k`` best survivors as image-space XYXY boxes
    (B, k, 4) float32 with their scores (B, k), the mask of real (and, with
    ``nms_iou``, NMS-kept) entries (B, k), the exact survivor count (B,)
    int32 (-1 when it exceeds ``k``), and the number of weak-classifier
    evaluations (B,) int32 (zeros unless ``with_n_weak``).  ``packed`` is
    the packed pyramid plan; ``fn`` is a :class:`BatchedDetector`.
    """
    _no_mesh(mesh)
    if two_phase:
        raise NotImplementedError("two-phase serving is not ported yet "
                                  "(ROADMAP item A13)")
    if fast:
        raise NotImplementedError("fast serving mode is not ported yet "
                                  "(ROADMAP item A6)")
    if n_scales is not None:
        if not isinstance(n_scales, int) or n_scales < 1:
            raise ValueError(f"n_scales must be a positive int, got "
                             f"{n_scales!r}")
        raise NotImplementedError("n_scales serving is not ported yet "
                                  "(ROADMAP item A4)")
    if int(k) < 1:
        raise ValueError(f"k must be positive, got {k}")
    h, w = (int(s) for s in image_shape)
    packed, _, _ = model._plan((h, w))
    fn = BatchedDetector(model, packed, (h, w), int(k), nms_iou,
                         with_n_weak, model._device_for(device))
    return fn, packed


def make_multi_detector_boxes(models: Sequence[Model],
                              image_shape: Tuple[int, int], k: int = 256,
                              nms_iou: Optional[float] = None,
                              response_scale=None, with_n_weak: bool = True,
                              device=None, mesh=None):
    """K models over ONE shared channel canvas, batched.

    The canvas is planned from the elementwise-minimum window and built
    once per batch; each model's frozen cascade (kernel B3) scans it with
    its own window grid and valid mask, and its survivors are extracted to
    its own ``k`` slots (scores scaled by ``response_scale``, NMS per model
    with ``nms_iou``).  Returns ``(fn, packed)``; ``fn(images) -> (rects,
    scores, valid, label, count, n_weak)`` with shapes (B, K*k, 4),
    (B, K*k), (B, K*k), (B, K*k) int32 model index, (B, K) per-model exact
    survivor counts (-1 past ``k``) and (B,) int32.  Runs on ``device``
    (the first model's when None)."""
    _no_mesh(mesh)
    if response_scale is None:
        response_scale = [1.0] * len(models)
    if len(response_scale) != len(models):
        raise ValueError("Wrong response_scale parameter")
    h, w = (int(s) for s in image_shape)
    packed, smooth, cf = shared_plan(models, (h, w))
    dev = models[0]._device_for(device)
    canvas = channel_canvas(packed, (h, w), smooth, cf, dev)
    scans = [(window_grid(packed, mm.shape[:2], dev), mm._operands(dev),
              float(np.float32(s))) for mm, s in zip(models, response_scale)]

    def fn(images: torch.Tensor):
        B = _check_images(images, (h, w), dev)
        if not packed.levels:
            z = lambda *s, dt: torch.zeros(s, dtype=dt, device=dev)
            return (z(B, 0, 4, dt=torch.float32), z(B, 0, dt=torch.float32),
                    z(B, 0, dt=torch.bool), z(B, 0, dt=torch.int32),
                    z(B, len(models), dt=torch.int32), z(B, dt=torch.int32))
        cv = canvas(images)  # once for every model
        outs: List = []
        n_weak_total = torch.zeros(B, dtype=torch.int32, device=dev)
        for kix, (grid, ops, scale) in enumerate(scans):
            with span("wb.cascade"):
                masked, n_weak, count = cascade_masked(cv, grid.valid, ops)
            with span("wb.extract"):
                rects, scores, valid, count = extract_detections(
                    masked, count, grid.level_id, grid.offsets,
                    grid.inv_scales, grid.window, k)
                scores = scores * scale
            if nms_iou is not None:
                with span("wb.nms"):
                    valid = valid & nms(rects, scores, valid, float(nms_iou))
            outs.append((rects, scores, valid,
                         torch.full(scores.shape, kix, dtype=torch.int32,
                                    device=dev), count))
            n_weak_total += n_weak
        cat = lambda i: torch.cat([o[i] for o in outs], dim=1)
        if not with_n_weak:
            n_weak_total.zero_()
        return (cat(0), cat(1), cat(2), cat(3),
                torch.stack([o[4] for o in outs], dim=1), n_weak_total)

    return fn, packed


def detect_batch(model: Model, images, k: int = 4096, mesh=None
                 ) -> List[Boxes]:
    """Batched detection with extraction on the model's device: one
    :class:`Boxes` per image (before NMS), the same survivor set as
    ``Model.detect``.  An image with more than ``k`` survivors falls back
    to ``Model.detect``."""
    images = as_image(images, ndim=3)
    fn, _ = make_batched_detector_boxes(model, images.shape[1:], k=k,
                                        mesh=mesh)
    rects, scores, valid, count, _ = (
        a.cpu().numpy() for a in fn(torch.from_numpy(images).to(fn.device)))
    out = []
    for b in range(images.shape[0]):
        if count[b] < 0:
            out.append(model.detect(images[b]))
            continue
        sel = valid[b]
        bx = Boxes(rects[b][sel])
        bx.set_field("scores", scores[b][sel].astype(np.float32))
        out.append(bx)
    return out
