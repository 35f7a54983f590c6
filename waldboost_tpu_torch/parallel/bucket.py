"""True-size detection inside shape buckets: serving at any frame size.

Counterpart of ``waldboost_tpu/parallel/bucket.py``.  A frame size is
snapped up to a coarse bucket, and the bucket's packed pyramid plan (the
packer's layout search, run once per bucket) gives every level its place
on the canvas.  For each real size, :func:`bucket_geometry` puts the
levels of the real-size pyramid into those places: a
:class:`~waldboost_tpu_torch.packing.PackedPyramidPlan` with the bucket's
canvas, halo, bands and placements and the real levels' extents.  All the
port derives from a packed plan then follows unchanged (the plane tables
of kernel B1 and of the float builds, the smooth interior mask, the valid
mask and level maps, the FPGA family's masks), so a new size costs host
tables and no packer run.  Each real level lies inside its bucket slot, a
slot's area beyond the level's halo is a gap (B1 writes 0 there; the JAX
package fills it with clamped copies), and no valid window reads it, so
the survivors and scores are ``Model.detect``'s at the real size, uint8
and float frames alike.

One bucket program runs the octave chain of the real-size crop of a
batch padded to the bucket, the planes (B1, or the float builds), the
channels (B2, B2d or B5), the walk (B3) with the size's valid mask, the
extraction with its level maps, and NMS.  Fast serving mode follows the
JAX package's bucket: uint8 frames take B2's exact canvas rounded to
bfloat16 and walked by B3f, float frames the float-fast planes, B2f and
B3f; the FPGA family ignores it.

A channel function without a canvas form (one a user registers) has no
bucket program, as in the JAX package (``parallel/bucket.py``:
``make_bucket_detector_boxes`` returns None): ``BucketedDetector`` serves
each of its frames with ``Model.detect`` at the true size, then NMS.

Shrink 1 and channel functions without a polyphase form (grad_mag) take
the image-space canvas (``ops/image_canvas.py``) of the same packed plan;
its reflect halos, masks and the magnitude's second reflection follow
from the real levels in their slots, as everything else does.

``verifier=(module, params)`` fuses the CNN verifier
(:mod:`waldboost_tpu_torch.verification`) into the program: after the
extraction each valid survivor's window is cropped from the canvas on
the device and re-scored ``cnn(X) + H``; NMS ranks by the verified
scores, and the cascade's scores come back beside them.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..boxes import Boxes, non_max_suppression
from ..canvas import (FAST_FLOAT, ChannelCanvas, WindowGrid, as_image,
                      serving_opts)
from ..channels import pyramid_plan, resolve_channel_function
from ..model import Model
from ..mining import gather_windows
from ..ops.cascade_static import cascade_masked
from ..ops.nms import extract_detections, nms
from ..packing import PackedPyramidPlan, _packed_plan_cached
from ..profiling import span
from ..verification import detect_and_verify, get_verifier_program
from .detect import (MeshDetector, empty_results, extract_boxes, to_device,
                     to_host)
from .mesh import gather

__all__ = ["BucketedDetector", "BucketProgram", "BucketSize",
           "make_bucket_detector_boxes", "bucket_geometry"]


@functools.lru_cache(maxsize=256)
def bucket_geometry(bucket_hw: Tuple[int, int], real_hw: Tuple[int, int],
                    window: Tuple[int, int], shrink: int, n_per_oct: int,
                    cf_name: str) -> PackedPyramidPlan:
    """The packed plan of ``real_hw`` frames in the ``bucket_hw`` bucket:
    the bucket plan's canvas, halo, bands and placements, each slot
    holding the real-size level of its plan index; slots whose level has
    no window origin at the real size are dropped."""
    cf = resolve_channel_function(cf_name)
    h, w = (int(v) for v in real_hw)
    if not (0 < h <= bucket_hw[0] and 0 < w <= bucket_hw[1]):
        raise ValueError(f"frame {real_hw} does not fit bucket {bucket_hw}")
    packed = _packed_plan_cached(int(bucket_hw[0]), int(bucket_hw[1]), shrink,
                                 n_per_oct, tuple(window), halo=cf.halo)
    plan = pyramid_plan(h, w, shrink, n_per_oct)
    m, n = window
    levels = []
    for pl in packed.levels:
        rlv = plan[pl.plan_index] if pl.plan_index < len(plan) else None
        if rlv is None or rlv.out_height <= m or rlv.out_width <= n:
            continue
        if rlv.height > pl.level.height or rlv.width > pl.level.width:
            raise ValueError(f"level {pl.plan_index} of {real_hw} outgrows "
                             f"its slot in bucket {bucket_hw}")
        levels.append(dataclasses.replace(pl, level=rlv))
    return dataclasses.replace(packed, levels=tuple(levels))


class BucketSize:
    """One real frame size's operands of a bucket program on its device:
    its packed plan (:func:`bucket_geometry`), the channel-canvas steps
    (exact, and with ``fast`` the float-fast one) and the window grid."""

    def __init__(self, packed: PackedPyramidPlan, real_hw: Tuple[int, int],
                 window: Tuple[int, int], smooth: int, cf, device,
                 fast: bool, fast_float: str):
        self.real_hw = tuple(real_hw)
        self.packed = packed
        self.canvas = ChannelCanvas(packed, real_hw, smooth, cf, device)
        self.fast_canvas = ChannelCanvas(packed, real_hw, smooth, cf, device,
                                         True, fast_float) \
            if fast and cf.fused_kind is None else None
        self.grid = WindowGrid(packed, window, device)


class BucketProgram:
    """``fn(images, geom) -> (rects, scores, valid, count, n_weak)`` of one
    bucket: ``images`` a (B, Hb, Wb) uint8 or float32 batch padded to the
    bucket, ``geom`` a :class:`BucketSize` of :meth:`geometry`; the
    outputs as :func:`~waldboost_tpu_torch.parallel.detect.
    make_batched_detector_boxes`'s at the real size.  With a ``verifier``
    the scores are the verified ones and a sixth output holds the
    cascade's.  Built by :func:`make_bucket_detector_boxes`."""

    def __init__(self, model: Model, bucket_hw: Tuple[int, int], k: int,
                 nms_iou: Optional[float], with_n_weak: bool, device,
                 fast: bool, fast_float: str, verifier=None):
        shrink, n_per_oct, smooth, cf = serving_opts(model.channel_opts,
                                                     model.shape[2])
        if fast_float not in FAST_FLOAT:
            raise ValueError(f"fast_float must be one of {sorted(FAST_FLOAT)}"
                             f", got {fast_float!r}")
        self.bucket_hw = tuple(int(v) for v in bucket_hw)
        self.window = model.shape[:2]
        self.k = int(k)
        self.nms_iou = nms_iou
        self.with_n_weak = with_n_weak
        self.device = device
        self.fast = bool(fast) and cf.fused_kind is None
        self.fast_float = fast_float
        self._opts = (shrink, n_per_oct, smooth, cf)
        # the bucket's packer run: every real size reuses its placements
        self.packed = _packed_plan_cached(self.bucket_hw[0],
                                          self.bucket_hw[1], shrink,
                                          n_per_oct, self.window,
                                          halo=cf.halo)
        self.cascade_ops = model._operands(device)
        self.verify = None if verifier is None else \
            get_verifier_program(*verifier, device)

    def geometry(self, real_hw: Tuple[int, int]) -> BucketSize:
        """The operands of ``real_hw`` frames (host tables, then copied to
        the device; the plane tables of each frame type at its first
        batch)."""
        shrink, n_per_oct, smooth, cf = self._opts
        packed = bucket_geometry(self.bucket_hw, tuple(real_hw), self.window,
                                 shrink, n_per_oct, cf.name)
        return BucketSize(packed, real_hw, self.window, smooth, cf,
                          self.device, self.fast, self.fast_float)

    def launch(self, images: torch.Tensor, geom: BucketSize):
        """The canvas and the walk of a batch, queued on the device: what
        :meth:`finish` takes."""
        Hb, Wb = self.bucket_hw
        if not isinstance(images, torch.Tensor) or images.dim() != 3 \
                or tuple(images.shape[1:]) != (Hb, Wb) \
                or images.dtype not in (torch.uint8, torch.float32):
            raise ValueError(f"images must be a (B, {Hb}, {Wb}) uint8 or "
                             f"float32 tensor")
        if images.device != self.device:
            raise ValueError(f"images on {images.device}, detector built for "
                             f"{self.device}")
        B = images.shape[0]
        if not geom.packed.levels:
            return B, geom
        h, w = geom.real_hw
        crop = images[:, :h, :w]
        if self.fast and crop.is_floating_point():
            canvas = geom.fast_canvas(crop)
            exact = canvas
        else:
            canvas = exact = geom.canvas(crop)
            if self.fast:  # B2's exact values, walked in bfloat16
                canvas = canvas.to(torch.bfloat16)
        with span("wb.cascade"):
            return geom, exact, cascade_masked(canvas, geom.grid.valid,
                                               self.cascade_ops)

    def finish(self, launched):
        """The outputs of a launched batch: extraction, the verifier and
        NMS, which wait for the device."""
        if isinstance(launched[0], int):
            return empty_results(launched[0], self.device)
        geom, exact, (masked, n_weak, count) = launched
        if not self.with_n_weak:
            n_weak = torch.zeros_like(n_weak)
        if self.verify is None:
            rects, scores, keep, count = extract_boxes(
                masked, count, geom.grid, self.k, self.nms_iou)
            return rects, scores, keep, count, n_weak
        grid = geom.grid
        with span("wb.extract"):
            rects, casc, keep, count, rs, cs = extract_detections(
                masked, count, grid.level_id, grid.offsets, grid.inv_scales,
                grid.window, self.k, with_coords=True)
        with span("wb.verify"):
            with span("wb.sync"):
                b, j = keep.nonzero(as_tuple=True)
            crops = gather_windows(exact, b, rs[b, j], cs[b, j], grid.window)
            scores = casc.clone()
            scores[b, j] = self.verify(crops, casc[b, j])
        if self.nms_iou is not None:
            with span("wb.nms"):
                keep = keep & nms(rects, scores, keep, float(self.nms_iou))
        return rects, scores, keep, count, n_weak, casc

    def __call__(self, images: torch.Tensor, geom: BucketSize):
        return self.finish(self.launch(images, geom))


class MeshBucketProgram(MeshDetector):
    """A :class:`BucketProgram` on each mesh device of this process:
    ``fn(images, fn.geometry(real_hw))`` with the full padded batch (or
    this process's shards) returns each output as a list of shards."""

    @property
    def packed(self) -> PackedPyramidPlan:
        return self.parts[0].packed

    def geometry(self, real_hw: Tuple[int, int]):
        """The operands of ``real_hw`` frames on each mesh device."""
        return [p.geometry(real_hw) for p in self.parts]


def make_bucket_detector_boxes(model: Model, bucket_hw: Tuple[int, int],
                               k: int = 1024,
                               nms_iou: Optional[float] = None, mesh=None,
                               with_n_weak: bool = False, verifier=None,
                               device=None, fast: bool = False,
                               fast_float: str = "f32"):
    """One program for true-size detection at every frame size inside
    ``bucket_hw``: ``(fn, packed)`` with ``fn`` a :class:`BucketProgram`
    (``fn(images, fn.geometry(real_hw))``) and ``packed`` the bucket's
    packed plan.  ``count == -1`` flags more than ``k`` survivors (callers
    fall back to the per-size path).  ``fast`` and ``fast_float`` are the
    serving mode, fixed at build time; ``verifier=(module, params)`` fuses
    the CNN rescoring in; runs on ``device`` (the model's when None), or
    with ``mesh`` on each mesh device (a :class:`MeshBucketProgram`).
    None when the model's channel function has no canvas form."""
    if int(k) < 1:
        raise ValueError(f"k must be positive, got {k}")
    if not serving_opts(model.channel_opts, model.shape[2])[3].canvas:
        return None
    build = lambda d: BucketProgram(model, bucket_hw, k, nms_iou,
                                    with_n_weak, d, fast, fast_float,
                                    verifier)
    if mesh is None:
        fn = build(model._device_for(device))
    else:
        fn = MeshBucketProgram(mesh, [build(d) for d in mesh.local_devices])
    return fn, fn.packed


class BucketedDetector:
    """Serving at any frame size: true-size detection with one set-up per
    coarse bucket.

    Each (H, W) snaps up to the bucket grid (:meth:`_snap`); a bucket's
    set-up runs the packer once (``compiles`` counts them), and each real
    size inside it costs its host tables, kept in a per-bucket LRU of
    ``MAX_SIZES``.  ``detect(image)`` equals ``Model.detect(image)`` (then
    NMS with ``nms_iou``) at every size, boxes and scores bitwise; an
    image with more than ``k`` survivors falls back to ``Model.detect`` on
    the same device, as does every image of a channel function without a
    canvas form.  ``detect_many`` groups images by (bucket, size, frame
    type) and runs each group in batches of ``max_batch``.  With
    ``track_cost`` each image's weak evaluations and scanned windows are
    folded into the model's cost counters, as ``Model.detect`` folds them.
    ``fast`` / ``fast_float``: fast serving mode (see
    :mod:`waldboost_tpu_torch.parallel.bucket`).  ``verifier=(module,
    params)``: every bucket program re-scores its survivors with the CNN
    verifier; 'scores' are the verified scores (NMS ranks by them) and
    'cascade_scores' the cascade's, as ``detect_and_verify`` gives them.
    Runs on ``device`` (the model's when None), or with ``mesh`` over its
    devices: each batch, padded with blank frames to a multiple of the
    mesh size, is split over them, and every process gets every box."""

    #: real sizes whose device tables each bucket keeps
    MAX_SIZES = 16

    def __init__(self, model: Model, bucket: int = 128, k: int = 1024,
                 nms_iou: Optional[float] = None, mesh=None,
                 max_batch: int = 16, track_cost: bool = False,
                 verifier=None, fast: bool = False, fast_float: str = "f32",
                 device=None):
        serving_opts(model.channel_opts, model.shape[2])
        if fast_float not in FAST_FLOAT:
            raise ValueError(f"fast_float must be one of {sorted(FAST_FLOAT)}"
                             f", got {fast_float!r}")
        self.model = model
        self.bucket = int(bucket)
        self.k = int(k)
        self.nms_iou = nms_iou
        self.max_batch = int(max_batch)
        self.track_cost = bool(track_cost)
        self.fast = bool(fast)
        self.fast_float = fast_float
        self.verifier = verifier
        self.mesh = mesh
        self.device = model._device_for(device) if mesh is None \
            else mesh.local_devices[0]
        self._programs: Dict[Tuple[int, int], BucketProgram] = {}
        self._sizes: Dict[Tuple[int, int], collections.OrderedDict] = {}
        self.compiles = 0  # bucket set-ups (packer runs) so far

    def _snap(self, h: int, w: int) -> Tuple[int, int]:
        b = self.bucket
        m, n, _ = self.model.shape
        return max(-(-h // b) * b, m * 2), max(-(-w // b) * b, n * 2)

    def _program(self, bucket_hw) -> Optional[BucketProgram]:
        if bucket_hw not in self._programs:
            built = make_bucket_detector_boxes(
                self.model, bucket_hw, k=self.k, nms_iou=self.nms_iou,
                mesh=self.mesh, with_n_weak=self.track_cost,
                verifier=self.verifier, device=self.device, fast=self.fast,
                fast_float=self.fast_float)
            self._programs[bucket_hw] = None if built is None else built[0]
            self._sizes[bucket_hw] = collections.OrderedDict()
            self.compiles += 1
        return self._programs[bucket_hw]

    def _geometry(self, bucket_hw, real_hw) -> BucketSize:
        sizes = self._sizes[bucket_hw]
        if real_hw in sizes:
            sizes.move_to_end(real_hw)
        else:
            sizes[real_hw] = self._programs[bucket_hw].geometry(real_hw)
            if len(sizes) > self.MAX_SIZES:
                sizes.popitem(last=False)
        return sizes[real_hw]

    def _fallback_detect(self, image) -> Boxes:
        """The per-size path (more than ``k`` survivors, or no canvas
        form), then NMS."""
        if self.verifier is not None:
            bx = detect_and_verify(image, self.model, *self.verifier)
        else:
            bx = self.model._detect(image, self.device)
        if self.nms_iou is not None and len(bx):
            bx = non_max_suppression(bx, iou_threshold=float(self.nms_iou))
        return bx

    def _run_group(self, bucket_hw, real_hw, images):
        fn = self._program(bucket_hw)
        if fn is None:
            # no canvas form: no bucket program (Model.detect tracks the
            # cost itself)
            return [self._fallback_detect(im) for im in images]
        geom = self._geometry(bucket_hw, real_hw)
        H, W = bucket_hw
        out = []
        # no padding of the batch to a power of two: nothing is compiled
        # per batch size; under a mesh, blank frames fill the last shards
        mult = 1 if self.mesh is None else self.mesh.size
        for i0 in range(0, len(images), self.max_batch):
            chunk = images[i0:i0 + self.max_batch]
            batch = np.zeros((-(-len(chunk) // mult) * mult, H, W),
                             chunk[0].dtype)
            for j, im in enumerate(chunk):
                batch[j, :im.shape[0], :im.shape[1]] = im
            if self.mesh is None:
                outs = fn(to_device(batch, self.device), geom)
            else:
                outs = [gather(o, self.mesh) for o in fn(batch, geom)]
            rects, scores, valid, count, n_weak, *casc = to_host(outs)
            for j, im in enumerate(chunk):
                if count[j] < 0:
                    out.append(self._fallback_detect(im))
                    continue
                if self.track_cost:
                    self.model._track_cost(int(n_weak[j]), geom.grid.n_loc)
                bx = Boxes(rects[j][valid[j]])
                bx.set_field("scores", scores[j][valid[j]].astype(np.float32))
                if casc:
                    bx.set_field("cascade_scores", casc[0][j][valid[j]])
                out.append(bx)
        return out

    def detect(self, image) -> Boxes:
        return self.detect_many([image])[0]

    def detect_many(self, images):
        """One :class:`Boxes` per (H, W) image, in order."""
        images = [as_image(im) for im in images]
        groups: Dict = {}
        for idx, im in enumerate(images):
            key = (self._snap(*im.shape), im.shape, im.dtype.str)
            groups.setdefault(key, []).append(idx)
        out = [None] * len(images)
        for (bucket_hw, real_hw, _), idxs in groups.items():
            boxes = self._run_group(bucket_hw, real_hw,
                                    [images[i] for i in idxs])
            for i, b in zip(idxs, boxes):
                out[i] = b
        return out
