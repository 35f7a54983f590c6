"""Batched detection on the device.

Counterpart of ``waldboost_tpu/parallel/detect.py``:
``make_batched_detector`` (unmasked maps through kernel B4, with the
two-phase ``n_stages_cap``), ``make_batched_detector_boxes`` (its masked
path, and its two-phase and row-wise options),
``make_multi_detector_boxes`` and ``detect_batch``; ``BucketedDetector``
and ``make_bucket_detector_boxes`` (any frame size) come from
:mod:`.bucket`.  The main path for a (B, H, W) uint8 batch:

    canvas    octaves, planes (B1), channel canvas (B2 grad_hist, B5 FPGA)
              (canvas.py)
    cascade   frozen cascade, masked score map (kernel B3, ops/cascade_static.py)
    extract   exact top-k (kernel S2, ops/nms.py::topk_masked), boxes and
              greedy NMS (ops/nms.py, plain torch)

With ``two_phase=True`` (:class:`TwoPhaseDetector`) the cascade step is
kernel B4 over the first ``prefix`` stages, the exact compaction of its
survivors (kernel S2, ``ops/nms.py::topk_masked``) and the walk of
the remaining stages over them (kernel S1, ``ops/cascade.py::
cascade_suffix_sparse``); with an ``extractor`` other than ``"approx"``
(:class:`RowwiseDetector`) it is B4 over every stage and the row-wise
extraction.

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
and device time to the layers; each point where the host waits for the
card (the uploads and copies to the host of :func:`detect_batch` and
``BucketedDetector``, and on the CPU the NMS loop's tests) is a
``wb.sync`` span.

Every entry point runs on ``device``, or on the model's device when None
(which is the card unless the model was loaded or moved elsewhere).  With
``mesh`` (:mod:`.mesh`) a batch is split over the mesh devices, one
detector per device (:class:`MeshDetector`, outputs as lists of shards),
and ``make_tile_sharded_detector`` splits one frame's window grid into
bands of origin rows, one per mesh device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..boxes import Boxes
from ..canvas import (as_image, channel_canvas, is_kernel_canvas, serving_opts,
                      window_grid)
from ..model import Model, shared_plan
from ..ops.cascade import cascade_suffix_sparse
from ..ops.cascade_static import cascade_masked, cascade_response
from ..ops.nms import (complete_count, extract_detections,
                       extract_detections_rowwise, nms, origin_boxes,
                       topk_masked)
from ..packing import PackedPyramidPlan
from ..profiling import span, tracing
from .mesh import Mesh, as_shards, gather

__all__ = ["BatchedDetector", "MeshDetector", "TwoPhaseDetector",
           "RowwiseDetector", "TWO_PHASE_BATCH_PREFIX",
           "TWO_PHASE_BATCH_CAPACITY", "make_batched_detector",
           "make_batched_detector_boxes", "make_multi_detector_boxes",
           "make_tile_sharded_detector", "detect_batch", "span",
           "BucketedDetector", "make_bucket_detector_boxes"]


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


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """``array`` copied to ``device``: a blocking copy from pageable
    memory, so a ``wb.sync`` span."""
    with span("wb.sync"):
        return torch.from_numpy(array).to(device)


def to_host(tensors) -> List[np.ndarray]:
    """Each tensor copied to the host as a numpy array, each copy a
    ``wb.sync`` span: the first waits for the card."""
    traced = tracing()
    out = []
    for t in tensors:
        with span("wb.sync", traced):
            out.append(t.cpu().numpy())
    return out


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

    def launch(self, images: torch.Tensor):
        """The canvas and the walk of a (B, H, W) batch, queued on the
        device without waiting for it: what :meth:`finish` takes."""
        B = _check_images(images, self.image_shape, self.device)
        if not self.packed.levels:
            return B
        canvas = self.canvas(images)
        with span("wb.cascade"):
            return self.cascade(canvas)

    def finish(self, launched):
        """``(rects, scores, valid, count, n_weak)`` of a launched batch:
        the extraction and NMS, which wait for the device."""
        if isinstance(launched, int):
            return empty_results(launched, self.device)
        masked, n_weak, count = launched
        rects, scores, keep, count = self.extract(masked, count)
        if not self.with_n_weak:
            n_weak = torch.zeros_like(n_weak)
        return rects, scores, keep, count, n_weak

    def __call__(self, images: torch.Tensor):
        """``(rects, scores, valid, count, n_weak)`` of a (B, H, W) batch;
        see :func:`make_batched_detector_boxes`."""
        return self.finish(self.launch(images))


def serving_canvas(packed, image_shape, smooth, cf, device, fast: bool,
                   fast_float: str, counts: bool):
    """The canvas step of a serving walk.  In fast mode an image-space or
    per-level canvas (shrink 1, grad_mag, a function without a canvas
    form) is the exact one, rounded to bfloat16 only for a masked walk
    that does not count n_weak (``counts``): the JAX package's walk drops
    ``fast`` when it counts (``cascade_masked_grid_static``), and its
    response walk has none."""
    return channel_canvas(packed, image_shape, smooth, cf, device,
                          fast and (is_kernel_canvas(packed, cf)
                                    or not counts), fast_float)


class MeshDetector:
    """A detector's copies on this process's mesh devices, one per shard.

    ``fn(images)`` takes the full (B, H, W) batch (every process passes
    the same) or this process's shards (:func:`~.mesh.shard_array`) and
    returns each output as the list of this process's shards, on their
    devices; concatenated in mesh order (:func:`~.mesh.gather`) they are
    the unsharded detector's outputs, bitwise.  Every shard's canvas and
    walk are queued before any shard's extraction, so the cards work at
    the same time.  The extractions are queued in turn; on the card they
    read nothing back (NMS is kernel S3), so the host runs ahead of every
    card."""

    def __init__(self, mesh: Mesh, parts: Sequence):
        self.mesh = mesh
        self.parts = list(parts)

    def __call__(self, images, *per_part):
        """``per_part``: further arguments, each a list with one entry per
        part (a bucket program's geometries)."""
        shards = as_shards(images, self.mesh)
        launched = [p.launch(x, *a)
                    for p, x, *a in zip(self.parts, shards, *per_part)]
        outs = [p.finish(s) for p, s in zip(self.parts, launched)]
        return tuple(list(o) for o in zip(*outs))


def _on_mesh(mesh: Optional[Mesh], build, device):
    """``build(device)`` on ``device``, or one per mesh device of this
    process in a :class:`MeshDetector`."""
    if mesh is None:
        return build(device)
    return MeshDetector(mesh, [build(d) for d in mesh.local_devices])


class ResponseDetector:
    """``fn(images) -> (hs, alive, n_weak)`` of one device; built by
    :func:`make_batched_detector`."""

    def __init__(self, model: Model, packed: PackedPyramidPlan, image_shape,
                 smooth, cf, device, n_stages_cap, fast, fast_float):
        self.packed = packed
        self.image_shape = image_shape
        self.device = device
        self.n_stages_cap = n_stages_cap
        self.grid = window_grid(packed, model.shape[:2], device)
        self.canvas = serving_canvas(packed, image_shape, smooth, cf, device,
                                     fast, fast_float, counts=True)
        self.ops = model._operands(device)

    def launch(self, images: torch.Tensor):
        B = _check_images(images, self.image_shape, self.device)
        if not self.packed.levels:
            gu, gv = self.grid.valid.shape
            z = lambda *s, dt: torch.zeros(s, dtype=dt, device=self.device)
            return (z(B, gu, gv, dt=torch.float32), z(B, gu, gv, dt=torch.bool),
                    z(B, dt=torch.int32))
        cv = self.canvas(images)
        with span("wb.cascade"):
            return cascade_response(cv, self.grid.valid, self.ops,
                                    self.n_stages_cap)

    def finish(self, launched):
        return launched

    __call__ = launch


def make_batched_detector(model: Model, image_shape: Tuple[int, int],
                          n_stages_cap: Optional[int] = None, device=None,
                          mesh: Optional[Mesh] = None, fast: bool = False,
                          fast_float: str = "f32"):
    """Build ``fn(images) -> (hs, alive, n_weak)`` for ``image_shape``
    frames: the (B, GU, GV) float32 and bool maps and per-image int32
    ``n_weak`` of the first ``n_stages_cap`` stages (all when None) over
    the packed canvas (kernels B1, B2 or B5, B4; with ``fast``, B2f and B4
    over the bfloat16 canvas, and float32 frames, as in
    :func:`make_batched_detector_boxes`).  Returns ``(fn, packed)``.

    With ``mesh`` (:mod:`.mesh`; it takes the place of ``device``) ``fn``
    is a :class:`MeshDetector`: the batch is split over the mesh devices,
    each shard runs the whole path on its device, and each output is a
    list of shards."""
    h, w = (int(s) for s in image_shape)
    packed, smooth, cf = model._plan((h, w))
    fn = _on_mesh(mesh, lambda d: ResponseDetector(
        model, packed, (h, w), smooth, cf, d, n_stages_cap, fast, fast_float),
        None if mesh else model._device_for(device))
    return fn, packed


#: two-phase batched serving's defaults (JAX's): the dense prefix's
#: stages and the compaction's capacity
TWO_PHASE_BATCH_PREFIX = 12
TWO_PHASE_BATCH_CAPACITY = 8192


class TwoPhaseDetector:
    """Two-phase batched detection on one device; built by
    :func:`make_batched_detector_boxes` with ``two_phase=True``.

    :meth:`launch` queues the canvas and kernel B4 over the first
    ``prefix`` stages; :meth:`finish` compacts each image's prefix
    survivors to ``cap`` entries (kernel S2), walks the remaining stages
    over them (kernel S1) and extracts the best ``k_out`` by final score,
    then by position in the compacted list (``lax.top_k``'s order; S2
    again), as JAX's ``_make_two_phase_detector_boxes`` does."""

    def __init__(self, model: Model, packed: PackedPyramidPlan, image_shape,
                 k: int, nms_iou: Optional[float], prefix: int,
                 capacity: int, device, fast: bool, fast_float: str):
        _, _, smooth, cf = serving_opts(model.channel_opts, model.shape[2])
        self.prefix_step = ResponseDetector(model, packed, image_shape,
                                            smooth, cf, device, prefix, fast,
                                            fast_float)
        self.device = device
        self.grid = self.prefix_step.grid
        self.window = model.shape[:2]
        self.prefix = int(prefix)
        self.nms_iou = nms_iou
        gu, gv = self.grid.valid.shape
        self.cap = min(int(capacity), max(gu * gv, 1))
        self.k_out = min(int(k), self.cap)

    def launch(self, images: torch.Tensor):
        """The canvas and the prefix walk, queued; what :meth:`finish`
        takes."""
        B = _check_images(images, self.prefix_step.image_shape, self.device)
        if not self.prefix_step.packed.levels:
            return B
        cv = self.prefix_step.canvas(images)
        with span("wb.cascade"):
            return (cv,) + cascade_response(cv, self.grid.valid,
                                            self.prefix_step.ops, self.prefix)

    def finish(self, launched):
        """``(rects, scores, valid, count, n_weak)`` of a launched batch.
        Kernel S2 (``ops/nms.py::topk_masked``) compacts the prefix
        survivors straight from B4's ``hs1`` and ``alive1`` and takes the
        final top ``k_out`` of S1's list; the survivor counts, the
        completeness and the -1 are computed on the device, so nothing
        here waits for it (without NMS)."""
        if isinstance(launched, int):
            return self._empty(launched)
        cv, hs1, alive1, nw1 = launched
        B, _, gv = hs1.shape
        with span("wb.compact"):
            scores_k, idx, count1 = topk_masked(
                hs1.reshape(B, -1), self.cap, alive=alive1.reshape(B, -1))
            alive_k = torch.isfinite(scores_k)
            _, complete = complete_count(scores_k, count1, self.cap)
        with span("wb.suffix"):
            H, alive_s, nw2 = cascade_suffix_sparse(
                cv, self.prefix_step.ops, self.window, None, idx, scores_k,
                alive_k, self.prefix)
        with span("wb.extract"):
            scores, sel, n_surv = topk_masked(H, self.k_out, alive=alive_s)
            valid = torch.isfinite(scores)
            at = torch.gather(idx, 1, sel)
            g = self.grid
            rects = origin_boxes(torch.div(at, gv, rounding_mode="floor"),
                                 at % gv, valid, g.level_id, g.offsets,
                                 g.inv_scales, self.window)
            count = torch.where(complete & (n_surv <= self.k_out), n_surv,
                                torch.full_like(n_surv, -1))
        if self.nms_iou is not None:
            with span("wb.nms"):
                valid = valid & nms(rects, scores, valid,
                                    float(self.nms_iou))
        return rects, scores, valid, count, nw1 + nw2

    def _empty(self, B: int):
        """The outputs for frames too small for any level: ``k_out`` empty
        slots a frame."""
        z = lambda *s, dt: torch.zeros(s, dtype=dt, device=self.device)
        return (z(B, self.k_out, 4, dt=torch.float32),
                torch.full((B, self.k_out), float("-inf"),
                           device=self.device),
                z(B, self.k_out, dt=torch.bool), z(B, dt=torch.int32),
                z(B, dt=torch.int32))

    def __call__(self, images: torch.Tensor):
        return self.finish(self.launch(images))


class RowwiseDetector:
    """Kernel B4 over every stage, then the row-wise extraction
    (``ops/nms.py::extract_detections_rowwise``) and NMS, on one device;
    built by :func:`make_batched_detector_boxes` with an ``extractor``
    other than ``"approx"``.  Like JAX's, it returns n_weak whatever
    ``with_n_weak`` says."""

    def __init__(self, model: Model, packed: PackedPyramidPlan, image_shape,
                 k: int, k_row: int, nms_iou: Optional[float], device,
                 fast: bool, fast_float: str):
        _, _, smooth, cf = serving_opts(model.channel_opts, model.shape[2])
        self.walk = ResponseDetector(model, packed, image_shape, smooth, cf,
                                     device, None, fast, fast_float)
        self.device = device
        self.window = model.shape[:2]
        self.k, self.k_row = int(k), int(k_row)
        self.nms_iou = nms_iou

    def launch(self, images: torch.Tensor):
        return self.walk.launch(images)

    def finish(self, launched):
        hs, alive, n_weak = launched
        g = self.walk.grid
        with span("wb.extract"):
            rects, scores, valid, count = extract_detections_rowwise(
                hs, alive, g.level_id, g.offsets, g.inv_scales, self.window,
                self.k_row, self.k)
        if self.nms_iou is not None:
            with span("wb.nms"):
                valid = valid & nms(rects, scores, valid,
                                    float(self.nms_iou))
        return rects, scores, valid, count, n_weak

    def __call__(self, images: torch.Tensor):
        return self.finish(self.launch(images))


def _positive(name: str, value) -> int:
    if isinstance(value, bool) or int(value) != value or int(value) < 1:
        raise ValueError(f"{name} must be a positive int, got {value!r}")
    return int(value)


def make_batched_detector_boxes(model: Model, image_shape: Tuple[int, int],
                                k: int = 1024,
                                nms_iou: Optional[float] = None,
                                with_n_weak: bool = True,
                                device=None, mesh: Optional[Mesh] = None,
                                two_phase="auto",
                                n_scales: Optional[int] = None,
                                fast: bool = False, fast_float: str = "f32",
                                k_row: int = 16, extractor: str = "approx",
                                prefix: int = TWO_PHASE_BATCH_PREFIX,
                                capacity: int = TWO_PHASE_BATCH_CAPACITY):
    """Build a batched detector for ``model`` on ``image_shape`` frames.

    Returns ``(fn, packed)``; ``fn(images)`` takes a (B, H, W) uint8 or
    float32 tensor on the detector's device and returns ``(rects, scores,
    valid, count, n_weak)``: per image the ``k`` best survivors as image-space XYXY boxes
    (B, k, 4) float32 with their scores (B, k), the mask of real (and, with
    ``nms_iou``, NMS-kept) entries (B, k), the exact survivor count (B,)
    int32 (-1 when it exceeds ``k``), and the number of weak-classifier
    evaluations (B,) int32 (zeros unless ``with_n_weak``).  ``packed`` is
    the packed pyramid plan; ``fn`` is a :class:`BatchedDetector`, or with
    ``mesh`` (which takes the place of ``device``) a
    :class:`MeshDetector` of one per mesh device, whose outputs are lists
    of shards.

    ``fast`` is fast serving mode (JAX's ``WB_SERVING_MODE=fast``): a
    bfloat16 canvas from kernel B2f, walked by B3f; float32 frames' planes
    are then float32 (``fast_float="f32"``) or bfloat16 (``"bf16"``, JAX's
    ``WB_FAST_FLOAT=bf16``).  The results are
    JAX's fast mode's, not the exact path's.  FPGA models have no fast
    variant: they serve uint8 frames as in exact mode.

    ``n_scales`` serves only the pyramid's first ``n_scales`` levels (the
    single-scale workload at 1): their packed plan runs through the same
    canvas step, walk, extraction and NMS.

    JAX's serving options, with JAX's defaults and outputs:

    * ``two_phase``: ``True`` builds a :class:`TwoPhaseDetector`: B4 over
      the first ``prefix`` stages, the exact compaction of each image's
      prefix survivors to ``cap = min(capacity, GU * GV)`` entries (S2),
      the remaining stages over them (S1), then the best ``min(k, cap)``.
      ``count`` is -1 when the prefix survivors exceed ``cap`` (the
      ``cap`` best of them are walked and returned) or the final ones
      ``min(k, cap)``; ``n_weak`` is always counted (the prefix's plus the
      walked entries'), and ``n_scales`` is not read (as in JAX).
      ``"auto"`` and ``False`` build the dense path.
    * ``extractor``: ``"approx"`` is the masked path above (JAX's
      approximate extraction equals it whenever it is complete); any other
      value builds a :class:`RowwiseDetector` (B4 over every stage, each
      grid row's best ``k_row``, then the best ``k``; ``count`` -1 also
      when a row holds more than ``k_row`` survivors; ``n_weak`` always
      counted), which takes no ``n_scales``.
    """
    if two_phase not in (True, False, "auto"):
        raise ValueError(f"two_phase must be True, False or 'auto', got "
                         f"{two_phase!r}")
    if n_scales is not None:
        _positive("n_scales", n_scales)
    _positive("k", k)
    h, w = (int(s) for s in image_shape)
    dev = None if mesh else model._device_for(device)
    if two_phase is True:
        prefix = int(prefix)
        if prefix < 0:
            raise ValueError(f"prefix must be >= 0, got {prefix}")
        _positive("capacity", capacity)
        packed, _, _ = model._plan((h, w))
        fn = _on_mesh(mesh, lambda d: TwoPhaseDetector(
            model, packed, (h, w), int(k), nms_iou, prefix, int(capacity), d,
            fast, fast_float), dev)
        return fn, packed
    if extractor != "approx":
        if n_scales is not None:
            raise ValueError("n_scales requires the masked serving path "
                             "(extractor='approx')")
        _positive("k_row", k_row)
        packed, _, _ = model._plan((h, w))
        fn = _on_mesh(mesh, lambda d: RowwiseDetector(
            model, packed, (h, w), int(k), int(k_row), nms_iou, d, fast,
            fast_float), dev)
        return fn, packed
    packed, _, _ = model._plan((h, w), n_scales)
    fn = _on_mesh(mesh, lambda d: BatchedDetector(
        model, packed, (h, w), int(k), nms_iou, with_n_weak, d, fast,
        fast_float), dev)
    return fn, packed


class MultiDetector:
    """K models over one shared canvas on one device; built by
    :func:`make_multi_detector_boxes`."""

    def __init__(self, models, packed, image_shape, smooth, cf, device, k,
                 nms_iou, response_scale, with_n_weak, fast, fast_float):
        self.packed = packed
        self.image_shape = image_shape
        self.device = device
        self.k = k
        self.nms_iou = nms_iou
        self.with_n_weak = with_n_weak
        self.canvas = serving_canvas(packed, image_shape, smooth, cf, device,
                                     fast, fast_float, with_n_weak)
        self.scans = [(window_grid(packed, mm.shape[:2], device),
                       mm._operands(device), float(np.float32(s)))
                      for mm, s in zip(models, response_scale)]

    def launch(self, images: torch.Tensor):
        """The shared canvas and every model's walk (kernel B3), queued."""
        B = _check_images(images, self.image_shape, self.device)
        if not self.packed.levels:
            return B
        cv = self.canvas(images)  # once for every model
        walks = []
        for grid, ops, _ in self.scans:
            with span("wb.cascade"):
                walks.append(cascade_masked(cv, grid.valid, ops))
        return walks

    def finish(self, launched):
        dev = self.device
        if isinstance(launched, int):
            z = lambda *s, dt: torch.zeros(s, dtype=dt, device=dev)
            B = launched
            return (z(B, 0, 4, dt=torch.float32), z(B, 0, dt=torch.float32),
                    z(B, 0, dt=torch.bool), z(B, 0, dt=torch.int32),
                    z(B, len(self.scans), dt=torch.int32), z(B, dt=torch.int32))
        outs: List = []
        B = launched[0][0].shape[0]
        n_weak_total = torch.zeros(B, dtype=torch.int32, device=dev)
        for kix, ((grid, _, scale), (masked, n_weak, count)) in enumerate(
                zip(self.scans, launched)):
            with span("wb.extract"):
                rects, scores, valid, count = extract_detections(
                    masked, count, grid.level_id, grid.offsets,
                    grid.inv_scales, grid.window, self.k)
                scores = scores * scale
            if self.nms_iou is not None:
                with span("wb.nms"):
                    valid = valid & nms(rects, scores, valid,
                                        float(self.nms_iou))
            outs.append((rects, scores, valid,
                         torch.full(scores.shape, kix, dtype=torch.int32,
                                    device=dev), count))
            n_weak_total += n_weak
        cat = lambda i: torch.cat([o[i] for o in outs], dim=1)
        if not self.with_n_weak:
            n_weak_total.zero_()
        return (cat(0), cat(1), cat(2), cat(3),
                torch.stack([o[4] for o in outs], dim=1), n_weak_total)

    def __call__(self, images: torch.Tensor):
        return self.finish(self.launch(images))


def make_multi_detector_boxes(models: Sequence[Model],
                              image_shape: Tuple[int, int], k: int = 256,
                              nms_iou: Optional[float] = None,
                              response_scale=None, with_n_weak: bool = True,
                              device=None, mesh: Optional[Mesh] = None,
                              fast: bool = False, fast_float: str = "f32"):
    """K models over ONE shared channel canvas, batched.

    The canvas is planned from the elementwise-minimum window and built
    once per batch; each model's frozen cascade (kernel B3) scans it with
    its own window grid and valid mask, and its survivors are extracted to
    its own ``k`` slots (scores scaled by ``response_scale``, NMS per model
    with ``nms_iou``).  Returns ``(fn, packed)``; ``fn(images) -> (rects,
    scores, valid, label, count, n_weak)`` with shapes (B, K*k, 4),
    (B, K*k), (B, K*k), (B, K*k) int32 model index, (B, K) per-model exact
    survivor counts (-1 past ``k``) and (B,) int32.  Runs on ``device``
    (the first model's when None), or with ``mesh`` on each mesh device
    (a :class:`MeshDetector`).  ``fast`` and ``fast_float`` as in
    :func:`make_batched_detector_boxes` (B2f, B3f)."""
    if response_scale is None:
        response_scale = [1.0] * len(models)
    if len(response_scale) != len(models):
        raise ValueError("Wrong response_scale parameter")
    h, w = (int(s) for s in image_shape)
    packed, smooth, cf = shared_plan(models, (h, w))
    fn = _on_mesh(mesh, lambda d: MultiDetector(
        models, packed, (h, w), smooth, cf, d, k, nms_iou, response_scale,
        with_n_weak, fast, fast_float),
        None if mesh else models[0]._device_for(device))
    return fn, packed


class TileShardedDetector:
    """One frame's window grid split over a mesh; built by
    :func:`make_tile_sharded_detector`."""

    def __init__(self, model: Model, image_shape, mesh: Mesh, boxes: bool,
                 k: int, nms_iou: Optional[float]):
        m, n, _ = model.shape
        self.image_shape = tuple(int(s) for s in image_shape)
        self.packed, smooth, cf = model._plan(self.image_shape)
        self.mesh = mesh
        self.device = mesh.local_devices[0]
        self.window = (m, n)
        self.boxes = boxes
        self.k = k
        self.nms_iou = nms_iou
        self.canvas = channel_canvas(self.packed, self.image_shape, smooth,
                                     cf, self.device)
        self.grid = window_grid(self.packed, self.window, self.device)
        gu, gv = self.grid.valid.shape
        self.rows = -(-gu // mesh.size)
        # dead rows pad the mask so that the bands divide evenly
        valid = np.zeros((self.rows * mesh.size, gv), np.uint8)
        valid[:gu] = self.grid.valid.cpu().numpy()
        self.starts = [(mesh.local_start + i) * self.rows
                       for i in range(mesh.n_local)]
        self.bands = [(torch.as_tensor(valid[s:s + self.rows], device=d),
                       model._operands(d))
                      for s, d in zip(self.starts, mesh.local_devices)]

    def __call__(self, image):
        h, w = self.image_shape
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.ascontiguousarray(image))
        images = image.to(self.device)[None]
        _check_images(images, (h, w), self.device)
        gu, gv = self.grid.valid.shape
        m = self.window[0]
        if not self.packed.levels:
            hs = torch.zeros((gu, gv), dtype=torch.float32, device=self.device)
            nw = torch.zeros((), dtype=torch.int32, device=self.device)
            return self._finish(hs, hs.bool(), nw)
        cv = self.canvas(images)
        # every band reads its rows and the window's m rows below them
        need = self.rows * self.mesh.size + m
        if cv.shape[2] < need:
            cv = F.pad(cv, (0, 0, 0, need - cv.shape[2]))
        outs = []
        for s, (valid, ops), d in zip(self.starts, self.bands,
                                      self.mesh.local_devices):
            band = cv[:, :, s:s + self.rows + m].contiguous().to(d)
            with span("wb.cascade"):
                outs.append(cascade_response(band, valid, ops))
        hs, alive, nw = (gather([o[i] for o in outs], self.mesh, self.device)
                         for i in range(3))
        return self._finish(hs.reshape(-1, gv)[:gu],
                            alive.reshape(-1, gv)[:gu], nw.sum())

    def _finish(self, hs, alive, nw):
        if not self.boxes:
            return hs, alive, nw
        masked = torch.where(alive, hs, float("-inf"))
        rects, scores, keep, count = extract_boxes(
            masked[None], alive.sum(dtype=torch.int32)[None], self.grid,
            self.k, self.nms_iou)
        return rects[0], scores[0], keep[0], count[0], nw


def make_tile_sharded_detector(model: Model, image_shape: Tuple[int, int],
                               mesh: Mesh, boxes: bool = False,
                               k: int = 1024,
                               nms_iou: Optional[float] = None):
    """Split ONE frame's window grid over ``mesh`` (single-frame latency).

    The packed canvas is built once, on this process's first mesh device
    (kernels B1, B2 or B5); each mesh device walks (kernel B4) a band of
    ``ceil(GU / n)`` window-origin rows, copied with the window's ``m``
    rows of halo below it, under the valid mask padded with dead rows, and
    the bands are gathered back.  Returns ``(fn, packed)``; ``fn(image)``
    of one (H, W) frame gives ``(hs, alive, n_weak)``: the (GU, GV) maps
    and the frame's int32 ``n_weak``, bitwise the unsharded
    :func:`make_batched_detector`'s; with ``boxes=True`` it gives
    ``(rects, scores, valid, count, n_weak)`` of
    :func:`make_batched_detector_boxes` for the one frame (the exact
    extraction, then NMS with ``nms_iou``), on the first mesh device.
    Every process passes the same frame and gets the whole result."""
    fn = TileShardedDetector(model, image_shape, mesh, boxes, int(k),
                             nms_iou)
    return fn, fn.packed


def detect_batch(model: Model, images, k: int = 4096, mesh=None,
                 k_row: int = 64) -> List[Boxes]:
    """Batched detection with extraction on the model's device (or over
    ``mesh``): one :class:`Boxes` per image (before NMS), the same
    survivor set as ``Model.detect``.  An image with more than ``k``
    survivors falls back to ``Model.detect``.  ``k_row`` is passed on as
    JAX passes it; the default extractor does not read it."""
    images = as_image(images, ndim=3)
    fn, _ = make_batched_detector_boxes(model, images.shape[1:], k=k,
                                        mesh=mesh, k_row=k_row)
    if mesh is None:
        outs = fn(to_device(images, fn.device))
    else:
        outs = [gather(o, mesh) for o in fn(images)]
    rects, scores, valid, count, _ = to_host(outs)
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
