"""Batched detection on the device.

Counterpart of ``waldboost_tpu/parallel/detect.py``:
``make_batched_detector`` (unmasked maps through kernel B4, with the
two-phase ``n_stages_cap``), ``make_batched_detector_boxes`` (its
one-program masked path), ``make_multi_detector_boxes`` and
``detect_batch``; ``BucketedDetector`` and ``make_bucket_detector_boxes``
(any frame size) come from :mod:`.bucket`.  The main path for a (B, H, W)
uint8 batch:

    canvas    octaves, planes (B1), channel canvas (B2 grad_hist, B5 FPGA)
              (canvas.py)
    cascade   frozen cascade, masked score map (kernel B3, ops/cascade_static.py)
    extract   exact top-k boxes and greedy NMS     (ops/nms.py, plain torch)

Float32 frames take the f32 octave chain, the float64 plane build and
kernel B2d in place of B1 and B2 (JAX's ``canvas_float_b``, exact float
serving).  Fast serving mode (``fast=True``, JAX's
``WB_SERVING_MODE=fast``) makes a bfloat16 grad_hist canvas with kernel
B2f and walks it with B3f (B4 for ``make_batched_detector``), float32
frames' planes float32 or bfloat16 by ``fast_float`` (JAX's
``WB_FAST_FLOAT``).  Both
are arguments, fixed when the detector is built: the port reads no
environment variable for them.

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
from ..canvas import (as_image, channel_canvas, is_image_space, serving_opts,
                      span, window_grid)
from ..device import no_mesh
from ..model import Model, shared_plan
from ..ops.cascade_static import cascade_masked, cascade_response
from ..ops.nms import extract_detections, nms
from ..packing import PackedPyramidPlan

__all__ = ["BatchedDetector", "make_batched_detector",
           "make_batched_detector_boxes", "make_multi_detector_boxes",
           "detect_batch", "span", "BucketedDetector",
           "make_bucket_detector_boxes"]


def _check_images(images, image_shape, device) -> int:
    """The batch size of a (B, H, W) uint8 or float32 batch."""
    h, w = image_shape
    if not isinstance(images, torch.Tensor):
        raise ValueError("images must be a torch tensor")
    if images.dtype not in (torch.uint8, torch.float32) or images.dim() != 3 \
            or tuple(images.shape[1:]) != (h, w):
        raise ValueError(f"images must be (B, {h}, {w}) uint8 or float32, "
                         f"got {tuple(images.shape)} {images.dtype}")
    if images.device != device:
        raise ValueError(f"images on {images.device}, detector built for "
                         f"{device}")
    return images.shape[0]


def extract_boxes(masked: torch.Tensor, count: torch.Tensor, grid, k: int,
                  nms_iou: Optional[float]):
    """``(rects, scores, keep, count)``: the ``k`` best survivors of a
    masked score map as boxes through ``grid``'s level maps, then greedy
    NMS with ``nms_iou`` (none when None)."""
    with span("wb.extract"):
        rects, scores, keep, count = extract_detections(
            masked, count, grid.level_id, grid.offsets, grid.inv_scales,
            grid.window, k)
    if nms_iou is not None:
        with span("wb.nms"):
            keep = keep & nms(rects, scores, keep, float(nms_iou))
    return rects, scores, keep, count


def empty_results(B: int, device):
    """The outputs of a detector over frames too small for any level:
    (B, 0, 4) boxes, (B, 0) scores and keep mask, (B,) counts and n_weak."""
    z = lambda *s, dt: torch.zeros(s, dtype=dt, device=device)
    return (z(B, 0, 4, dt=torch.float32), z(B, 0, dt=torch.float32),
            z(B, 0, dt=torch.bool), z(B, dt=torch.int32),
            z(B, dt=torch.int32))


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
                 device: torch.device, fast: bool = False,
                 fast_float: str = "f32"):
        _, _, smooth, cf = serving_opts(model.channel_opts, model.shape[2])
        self.packed = packed
        self.image_shape = image_shape
        self.window = model.shape[:2]
        self.k = k
        self.nms_iou = nms_iou
        self.with_n_weak = with_n_weak
        self.device = device
        self.canvas = serving_canvas(packed, image_shape, smooth, cf, device,
                                     fast, fast_float, with_n_weak)
        self.grid = window_grid(packed, self.window, device)
        self.cascade_ops = model._operands(device)

    def cascade(self, canvas: torch.Tensor):
        return cascade_masked(canvas, self.grid.valid, self.cascade_ops)

    def extract(self, masked: torch.Tensor, count: torch.Tensor):
        return extract_boxes(masked, count, self.grid, self.k, self.nms_iou)

    def __call__(self, images: torch.Tensor):
        """``(rects, scores, valid, count, n_weak)`` of a (B, H, W) batch;
        see :func:`make_batched_detector_boxes`."""
        B = _check_images(images, self.image_shape, self.device)
        if not self.packed.levels:
            return empty_results(B, self.device)
        canvas = self.canvas(images)
        with span("wb.cascade"):
            masked, n_weak, count = self.cascade(canvas)
        rects, scores, keep, count = self.extract(masked, count)
        if not self.with_n_weak:
            n_weak = torch.zeros_like(n_weak)
        return rects, scores, keep, count, n_weak


def serving_canvas(packed, image_shape, smooth, cf, device, fast: bool,
                   fast_float: str, counts: bool):
    """The canvas step of a serving walk.  In fast mode an image-space
    canvas (shrink 1, grad_mag) is the exact one, rounded to bfloat16 only
    for a masked walk that does not count n_weak (``counts``): the JAX
    package's walk drops ``fast`` when it counts
    (``cascade_masked_grid_static``), and its response walk has none."""
    return channel_canvas(packed, image_shape, smooth, cf, device,
                          fast and not (is_image_space(packed, cf) and counts),
                          fast_float)


def make_batched_detector(model: Model, image_shape: Tuple[int, int],
                          n_stages_cap: Optional[int] = None, device=None,
                          mesh=None, fast: bool = False,
                          fast_float: str = "f32"):
    """Build ``fn(images) -> (hs, alive, n_weak)`` for ``image_shape``
    frames: the (B, GU, GV) float32 and bool maps and per-image int32
    ``n_weak`` of the first ``n_stages_cap`` stages (all when None) over
    the packed canvas (kernels B1, B2 or B5, B4; with ``fast``, B2f and B4
    over the bfloat16 canvas, and float32 frames, as in
    :func:`make_batched_detector_boxes`).  Returns ``(fn, packed)``."""
    no_mesh(mesh, "serving")
    h, w = (int(s) for s in image_shape)
    dev = model._device_for(device)
    packed, smooth, cf = model._plan((h, w))
    grid = window_grid(packed, model.shape[:2], dev)
    canvas = serving_canvas(packed, (h, w), smooth, cf, dev, fast, fast_float,
                            counts=True)
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
                                fast: bool = False, fast_float: str = "f32"):
    """Build a batched detector for ``model`` on ``image_shape`` frames.

    Returns ``(fn, packed)``; ``fn(images)`` takes a (B, H, W) uint8 or
    float32 tensor on the detector's device and returns ``(rects, scores,
    valid, count, n_weak)``: per image the ``k`` best survivors as image-space XYXY boxes
    (B, k, 4) float32 with their scores (B, k), the mask of real (and, with
    ``nms_iou``, NMS-kept) entries (B, k), the exact survivor count (B,)
    int32 (-1 when it exceeds ``k``), and the number of weak-classifier
    evaluations (B,) int32 (zeros unless ``with_n_weak``).  ``packed`` is
    the packed pyramid plan; ``fn`` is a :class:`BatchedDetector`.

    ``fast`` is fast serving mode (JAX's ``WB_SERVING_MODE=fast``): a
    bfloat16 canvas from kernel B2f, walked by B3f; float32 frames' planes
    are then float32 (``fast_float="f32"``) or bfloat16 (``"bf16"``, JAX's
    ``WB_FAST_FLOAT=bf16``).  The results are
    JAX's fast mode's, not the exact path's.  FPGA models have no fast
    variant: they serve uint8 frames as in exact mode.

    ``n_scales`` serves only the pyramid's first ``n_scales`` levels (the
    single-scale workload at 1): their packed plan runs through the same
    canvas step, walk, extraction and NMS.
    """
    no_mesh(mesh, "serving")
    if two_phase:
        raise NotImplementedError("two-phase serving is not ported yet "
                                  "(ROADMAP item A13)")
    if n_scales is not None and (isinstance(n_scales, bool) or not
                                 isinstance(n_scales, int) or n_scales < 1):
        raise ValueError(f"n_scales must be a positive int, got "
                         f"{n_scales!r}")
    if int(k) < 1:
        raise ValueError(f"k must be positive, got {k}")
    h, w = (int(s) for s in image_shape)
    packed, _, _ = model._plan((h, w), n_scales)
    fn = BatchedDetector(model, packed, (h, w), int(k), nms_iou,
                         with_n_weak, model._device_for(device), fast,
                         fast_float)
    return fn, packed


def make_multi_detector_boxes(models: Sequence[Model],
                              image_shape: Tuple[int, int], k: int = 256,
                              nms_iou: Optional[float] = None,
                              response_scale=None, with_n_weak: bool = True,
                              device=None, mesh=None, fast: bool = False,
                              fast_float: str = "f32"):
    """K models over ONE shared channel canvas, batched.

    The canvas is planned from the elementwise-minimum window and built
    once per batch; each model's frozen cascade (kernel B3) scans it with
    its own window grid and valid mask, and its survivors are extracted to
    its own ``k`` slots (scores scaled by ``response_scale``, NMS per model
    with ``nms_iou``).  Returns ``(fn, packed)``; ``fn(images) -> (rects,
    scores, valid, label, count, n_weak)`` with shapes (B, K*k, 4),
    (B, K*k), (B, K*k), (B, K*k) int32 model index, (B, K) per-model exact
    survivor counts (-1 past ``k``) and (B,) int32.  Runs on ``device``
    (the first model's when None).  ``fast`` and ``fast_float`` as in
    :func:`make_batched_detector_boxes` (B2f, B3f)."""
    no_mesh(mesh, "serving")
    if response_scale is None:
        response_scale = [1.0] * len(models)
    if len(response_scale) != len(models):
        raise ValueError("Wrong response_scale parameter")
    h, w = (int(s) for s in image_shape)
    packed, smooth, cf = shared_plan(models, (h, w))
    dev = models[0]._device_for(device)
    canvas = serving_canvas(packed, (h, w), smooth, cf, dev, fast, fast_float,
                            with_n_weak)
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


from .bucket import (BucketedDetector,  # noqa: E402  (imports this module)
                     make_bucket_detector_boxes)
