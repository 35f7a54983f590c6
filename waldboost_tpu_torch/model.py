"""Detection model: window shape, channel options, cascade, and the Model
API on a device.

Counterpart of ``waldboost_tpu/model.py`` (``Model``, ``detect_multi``)
and of ``waldboost_tpu/training.py::DTree``'s file semantics.  A stage is
the JAX package's ``DTree.to_stage_dict()`` form: ``feature`` (k, 3) int32
(row, col, channel) with leaf rows zeroed, ``threshold`` and
``prediction`` float32, ``left``/``right`` int32 child indices (-1 at
leaves).

Inputs are numpy images and samples, as in JAX; outputs are the port's
host :class:`~waldboost_tpu_torch.boxes.Boxes` and numpy arrays, except
the canvases and maps ``scan_packed*`` return, which stay on the device.
A model runs on its device: the card unless it was loaded or moved
with ``device="cpu"``.

The detection paths:

* ``detect``, ``detect_topk`` and :func:`detect_multi`: channel canvas
  (kernels B1 and B2, or B5 for the FPGA channels), then kernel B4 over
  every stage.  JAX's ``detect`` takes a two-phase path for cascades
  longer than 12 stages (a 12-stage prefix, top-4096 compaction, then
  the suffix on the compacted windows)
  because the TPU's gathers and device-to-host link are slow (ROADMAP
  A13); it returns the same survivors, scores and n_weak whenever it does
  not overflow, and falls back to the dense path when it does.  The port
  runs the dense path always.
* ``scan_packed``, ``scan_packed_batch`` and ``predict_on_image``: kernel
  B6 over the padded runtime tables of :meth:`Model._get_cascade`.
* ``predict`` and ``survivor_histogram``: plain torch (the JAX package has
  no kernel for either).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import boxes as bbx
from . import model_io
from .boxes import Boxes
from .canvas import as_image, channel_canvas, serving_opts, window_grid
from .channels import (ChannelFunction, _normalize_opts,
                       resolve_channel_function)
from .device import resolve_device
from .ops.cascade import (Cascade, CascadeMeta, cascade_from_stages,
                          cascade_predict_samples, cascade_response_grid,
                          cascade_survivor_counts)
from .ops.cascade_static import (CascadeOperands, StaticCascade,
                                  cascade_response, static_cascade_from_model)
from .ops.nms import nms_device, topk_detections
from .packing import PackedPyramidPlan, _packed_plan_cached

__all__ = ["Model", "load", "detect_multi", "shared_plan"]


def stage_from_fields(tree: Dict) -> Dict[str, np.ndarray]:
    """Stage dict of a decoded DTree message: features of ``(-1, -1, -1)``
    triples and of leaves become ``(0, 0, 0)``."""
    feature = np.asarray(tree["feature"], np.int32).reshape(-1, 3).copy()
    left = np.asarray(tree["left"], np.int32).reshape(-1)
    feature[feature[:, 0] < 0] = 0
    feature[left < 0] = 0
    return dict(feature=feature,
                threshold=np.asarray(tree["threshold"], np.float32),
                left=left,
                right=np.asarray(tree["right"], np.int32).reshape(-1),
                prediction=np.asarray(tree["prediction"], np.float32))


def stage_to_fields(stage: Dict) -> Dict[str, np.ndarray]:
    """DTree message fields of a stage dict (leaf features as -1 triples)."""
    feature = np.asarray(stage["feature"], np.int32).reshape(-1, 3).copy()
    left = np.asarray(stage["left"], np.int32).reshape(-1)
    feature[left < 0] = -1
    return dict(feature=feature.reshape(-1), threshold=stage["threshold"],
                left=left, right=stage["right"],
                prediction=stage["prediction"])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _survivors(hs: torch.Tensor, alive: torch.Tensor):
    """Row-major ``(rs, cs, scores)`` numpy of one (GU, GV) map."""
    rc = torch.nonzero(alive).cpu().numpy()
    return rc[:, 0], rc[:, 1], hs[alive].cpu().numpy()


def _empty():
    return bbx.empty_boxes(scores=np.empty(0, np.float32))


def _canvas(images: np.ndarray, packed, smooth, cf, dev) -> torch.Tensor:
    """(B, C, Hc, Wc) canvas of a (B, H, W) uint8 numpy batch."""
    step = channel_canvas(packed, images.shape[1:], smooth, cf, dev)
    return step(torch.from_numpy(np.ascontiguousarray(images)).to(dev))


def shared_plan(models, image_hw
                ) -> Tuple[PackedPyramidPlan, int, ChannelFunction]:
    """``(packed, smooth, cf)`` of the one canvas several models scan: they
    must share channel options, and the plan is made for their
    elementwise-minimum window, so every model's levels exist."""
    key0 = _normalize_opts(models[0].channel_opts)
    if not all(_normalize_opts(mm.channel_opts) == key0 for mm in models):
        raise ValueError("models on one shared canvas need the same channel "
                         "options")
    for mm in models:
        shrink, n_per_oct, smooth, cf = serving_opts(mm.channel_opts,
                                                     mm.shape[2])
    window = (min(mm.shape[0] for mm in models),
              min(mm.shape[1] for mm in models))
    packed = _packed_plan_cached(int(image_hw[0]), int(image_hw[1]), shrink,
                                 n_per_oct, window, halo=cf.halo)
    return packed, smooth, cf


@dataclasses.dataclass
class _Cache:
    """Tables derived from the stages, rebuilt when the model changes."""

    version: int = -1
    static: Optional[StaticCascade] = None
    cascades: Dict = dataclasses.field(default_factory=dict)
    operands: Dict = dataclasses.field(default_factory=dict)


class Model:
    """A WaldBoost detector: ``shape`` (m, n, C), ``channel_opts``
    (shrink, n_per_oct, smooth, channels), the stage node tables and the
    per-stage rejection thresholds ``theta``, on ``device`` (the card when
    None)."""

    #: stage-count padding of the runtime tables (see _stage_bucket)
    STAGE_PAD = 8

    def __init__(self, shape, channel_opts, device=None):
        self.shape = tuple(int(s) for s in shape)
        opts = dict(channel_opts)
        opts["channels"] = resolve_channel_function(opts["channels"])
        self.channel_opts = opts
        self.stages: List[Dict[str, np.ndarray]] = []
        self.theta: List[float] = []
        self._device = device
        self._version = 0
        self._cache = _Cache()
        self.reset()

    # -- device -----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        """The device the model runs on (resolved at each use: None means
        the current CUDA device, and raises without a card)."""
        return resolve_device(self._device)

    def _device_for(self, device=None) -> torch.device:
        """``device`` resolved, or the model's device when None."""
        return resolve_device(device) if device is not None else self.device

    def to(self, device) -> "Model":
        self._device = resolve_device(device)
        return self

    # -- stats --------------------------------------------------------------
    @property
    def eval_cost(self) -> float:
        """Average weak-classifier evaluations per scanned window."""
        return self.n_weak / self.n_loc if self.n_loc > 0 else 0

    def reset(self) -> None:
        self.n_loc = 0
        self.n_weak = 0
        self.n_images = 0
        self.worst_eval_cost = 0.0
        self.stage_survivors = None

    def _track_cost(self, n_weak: int, n_loc: int, images: int = 1) -> None:
        """Fold one scan's counters into the totals and the worst case
        (a batched scan counts its batch average as one sample)."""
        self.n_weak += n_weak
        self.n_loc += n_loc
        if n_loc > 0:
            self.n_images += images
            self.worst_eval_cost = max(self.worst_eval_cost, n_weak / n_loc)

    def cost_stats(self) -> dict:
        return {
            "eval_cost": self.eval_cost,
            "worst_eval_cost": self.worst_eval_cost,
            "n_images": self.n_images,
            "n_loc": self.n_loc,
            "n_weak": self.n_weak,
            "stage_survivors": (None if self.stage_survivors is None
                                else np.asarray(self.stage_survivors)),
        }

    # -- container protocol ------------------------------------------------
    def __getitem__(self, i):
        return self.stages[i], self.theta[i]

    def __len__(self) -> int:
        return len(self.stages)

    def __bool__(self) -> bool:
        return bool(self.stages)

    def __iter__(self):
        yield from zip(self.stages, self.theta)

    def append(self, stage: Dict, theta: float) -> None:
        self.stages.append({
            "feature": np.asarray(stage["feature"], np.int32).reshape(-1, 3),
            "threshold": np.asarray(stage["threshold"], np.float32),
            "left": np.asarray(stage["left"], np.int32),
            "right": np.asarray(stage["right"], np.int32),
            "prediction": np.asarray(stage["prediction"], np.float32),
        })
        self.theta.append(float(np.float32(theta)))
        self._version += 1

    # -- tables ---------------------------------------------------------------
    @staticmethod
    def _stage_bucket(T: int) -> int:
        """Padded stage count of the runtime tables: multiples of
        ``STAGE_PAD`` up to 32 stages, powers of two beyond (the JAX
        package's jit buckets; padded stages are inert)."""
        T = max(T, 1)
        if T <= 32:
            return max(_round_up(T, Model.STAGE_PAD), Model.STAGE_PAD)
        return 1 << (T - 1).bit_length()

    def _fresh_cache(self) -> _Cache:
        if self._cache.version != self._version:
            self._cache = _Cache(version=self._version)
        return self._cache

    def _get_cascade(self) -> Tuple[Cascade, CascadeMeta]:
        """The runtime :class:`Cascade` (padded to ``_stage_bucket``) and
        its meta, on the model's device."""
        dev = self.device
        cache = self._fresh_cache()
        if dev not in cache.cascades:
            cache.cascades[dev] = cascade_from_stages(
                self.stages, self.theta,
                n_stages=self._stage_bucket(len(self.stages)), device=dev)
        return cache.cascades[dev]

    def _get_static_cascade(self) -> StaticCascade:
        """The unpadded host tables of the frozen-cascade kernels."""
        cache = self._fresh_cache()
        if cache.static is None:
            cache.static = static_cascade_from_model(self)
        return cache.static

    def _operands(self, device=None) -> CascadeOperands:
        """:meth:`_get_static_cascade` checked and moved to ``device`` (the
        model's when None)."""
        dev = self._device_for(device)
        cache = self._fresh_cache()
        if dev not in cache.operands:
            m, n, C = self.shape
            cache.operands[dev] = CascadeOperands.build(
                self._get_static_cascade(), (m, n), C, dev)
        return cache.operands[dev]

    # -- boxes --------------------------------------------------------------
    def get_boxes(self, r, c, scale) -> Boxes:
        """Window origins (r, c) at pyramid ``scale`` -> image-space XYXY
        boxes."""
        r = np.asarray(r)
        c = np.asarray(c)
        if r.size == 0:
            return Boxes(np.empty((0, 4), np.float32))
        m, n = self.shape[:2]
        x1 = c.reshape(-1, 1).astype(np.float32)
        y1 = r.reshape(-1, 1).astype(np.float32)
        rects = np.concatenate([x1, y1, x1 + n, y1 + m], axis=1)
        return Boxes(rects).normalized(scale=1.0 / scale)

    def _boxes_from_canvas_origins(self, rs, cs, scores,
                                   packed: PackedPyramidPlan, level_id_map,
                                   inv_scales) -> Boxes:
        """Canvas window origins -> image-space boxes with scores."""
        if np.size(rs) == 0:
            return _empty()
        m, n, _ = self.shape
        lid = level_id_map[rs, cs]
        offs = np.array([(pl.y, pl.x) for pl in packed.levels], np.int64)
        x1 = (cs - offs[lid, 1]).astype(np.float32)
        y1 = (rs - offs[lid, 0]).astype(np.float32)
        rects = np.stack([x1, y1, x1 + n, y1 + m], axis=1)
        rects *= inv_scales[lid][:, None]
        out = Boxes(rects)
        out.set_field("scores", np.asarray(scores, np.float32))
        return out

    # -- the packed pyramid ---------------------------------------------------
    def _plan(self, image_hw
              ) -> Tuple[PackedPyramidPlan, int, ChannelFunction]:
        """``(packed, smooth, cf)``: the packed plan of ``image_hw`` frames
        for this window, and the channel options the canvas needs."""
        m, n, C = self.shape
        shrink, n_per_oct, smooth, cf = serving_opts(self.channel_opts, C)
        packed = _packed_plan_cached(int(image_hw[0]), int(image_hw[1]),
                                     shrink, n_per_oct, (m, n), halo=cf.halo)
        return packed, smooth, cf

    def _scan_setup(self, images: np.ndarray):
        """``(packed, grid, canvas)`` of a (B, H, W) uint8 numpy batch on
        the model's device: the plan, this window's grid and the (B, C, Hc,
        Wc) canvas; None when the frames are too small for any level."""
        packed, smooth, cf = self._plan(images.shape[1:])
        if not packed.levels:
            return None
        dev = self.device
        grid = window_grid(packed, self.shape[:2], dev)
        return packed, grid, _canvas(images, packed, smooth, cf, dev)

    def _dense(self, image):
        """Canvas and kernel B4 over every stage for one image: ``(packed,
        grid, hs, alive)`` with the counters tracked, or None when the
        image is too small for any level."""
        setup = self._scan_setup(as_image(image)[None])
        if setup is None:
            return None
        packed, grid, canvas = setup
        hs, alive, n_weak = cascade_response(canvas, grid.valid,
                                             self._operands())
        self._track_cost(int(n_weak[0]), grid.n_loc)
        return packed, grid, hs, alive

    # -- inference ----------------------------------------------------------
    def predict(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """Cascade scores of (N,) + shape samples; rejected samples get
        -inf.  Returns ``(scores, mask)``."""
        X = np.asarray(X)
        n, *shape = X.shape
        if tuple(shape) != self.shape:
            raise ValueError(f"Invalid shape of X. Expected {self.shape}, "
                             f"given {tuple(shape)}")
        if not self.stages:
            return np.zeros(n, np.float32), np.ones(n, bool)
        if n == 0:
            return np.zeros(0, np.float32), np.zeros(0, bool)
        casc, meta = self._get_cascade()
        H, mask = cascade_predict_samples(torch.as_tensor(X,
                                                          device=casc.device),
                                          casc, meta)
        return H.cpu().numpy(), mask.cpu().numpy()

    def predict_on_image(self, X) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The cascade at every window origin of an HWC channel image
        (kernel B6 on the card): surviving ``(rs, cs, hs)``."""
        if not isinstance(X, torch.Tensor):
            X = torch.tensor(np.asarray(X))
        u, v, ch_image = X.shape
        m, n, ch_cls = self.shape
        if ch_image != ch_cls:
            raise ValueError(f"Invalid number of channels. Expected {ch_cls} "
                             f"given {ch_image}.")
        gu, gv = max(u - m, 0), max(v - n, 0)
        if gu == 0 or gv == 0:
            e = np.empty(0, np.int64)
            return e, e, np.empty(0, np.float32)
        if not self.stages:
            self._track_cost(0, gu * gv)
            rs, cs = np.indices((gu, gv))
            return rs.flatten(), cs.flatten(), np.zeros(gu * gv, np.float32)
        casc, _ = self._get_cascade()
        chw = X.to(casc.device, torch.float32).permute(2, 0, 1).contiguous()
        hs, alive, n_weak = cascade_response_grid(chw, casc, (m, n))
        self._track_cost(int(n_weak), gu * gv)
        return _survivors(hs, alive)

    def scan_packed(self, image):
        """One pass over the packed pyramid with kernel B6: ``(canvas,
        packed, rs, cs, hs)`` with the (C, Hc, Wc) canvas on the device and
        the survivors' canvas origins and scores in numpy; None when the
        image is too small for any level.  Tracks the eval-cost counters."""
        setup = self._scan_setup(as_image(image)[None])
        if setup is None:
            return None
        packed, grid, canvas = setup
        hs, alive, n_weak = cascade_response_grid(
            canvas[0], self._get_cascade()[0], self.shape[:2], grid.valid)
        self._track_cost(int(n_weak), grid.n_loc)
        return (canvas[0], packed) + _survivors(hs, alive)

    def scan_packed_batch(self, images, n_real: Optional[int] = None):
        """Batched :meth:`scan_packed` of B same-shape images, one launch
        of each kernel: ``(canvas (B, C, Hc, Wc), hs (B, GU, GV), packed,
        [(rs, cs)] * n_real)`` with canvas and hs on the device, or None
        when the image is too small for any level.  The leading ``n_real``
        images are real; the rest are padding, left out of the outputs and
        (up to integer rounding of the batch's n_weak) of the counters."""
        images = as_image(images, ndim=3)
        B = images.shape[0]
        n_real = B if n_real is None else int(n_real)
        setup = self._scan_setup(images)
        if setup is None:
            return None
        packed, grid, canvas = setup
        hs, alive, n_weak = cascade_response_grid(
            canvas, self._get_cascade()[0], self.shape[:2], grid.valid)
        self._track_cost(int(n_weak.sum()) * n_real // B,
                         grid.n_loc * n_real, images=n_real)
        rc = torch.nonzero(alive[:n_real]).cpu().numpy()
        per_image = [(rc[rc[:, 0] == i, 1], rc[rc[:, 0] == i, 2])
                     for i in range(n_real)]
        return canvas, hs, packed, per_image

    def survivor_histogram(self, image) -> np.ndarray:
        """Windows alive entering each stage over the packed pyramid of one
        image (plain torch); accumulates into ``stage_survivors``, which
        restarts when the stage count changes."""
        image = as_image(image)
        T = len(self)
        setup = self._scan_setup(image[None]) if T else None
        if setup is None:
            return np.zeros(T, np.int64)
        _, grid, canvas = setup
        counts, n_weak = cascade_survivor_counts(
            canvas[0], self._get_cascade()[0], self.shape[:2], grid.valid)
        counts = counts.cpu().numpy().astype(np.int64)[:T]
        self._track_cost(n_weak, grid.n_loc)
        if self.stage_survivors is None or len(self.stage_survivors) != T:
            self.stage_survivors = np.zeros(T, np.int64)
        self.stage_survivors += counts
        return counts

    def detect(self, image) -> Boxes:
        """Every surviving window of the full pyramid as an image-space box
        with a 'scores' field (before NMS), rows in canvas order."""
        dense = self._dense(image)
        if dense is None:
            return _empty()
        packed, grid, hs, alive = dense
        return self._boxes_from_canvas_origins(
            *_survivors(hs[0], alive[0]), packed, grid.level_id_np,
            grid.inv_scales_np)

    def detect_topk(self, image, k: int = 1024,
                    nms_iou: Optional[float] = None) -> Boxes:
        """The ``k`` best surviving windows as boxes, extracted on the
        device (score descending, lowest canvas index first among equal
        scores), optionally followed by greedy NMS on the device."""
        dense = self._dense(image)
        if dense is None:
            return _empty()
        _, grid, hs, alive = dense
        rects, scores, valid = topk_detections(
            hs, alive, grid.level_id, grid.offsets, grid.inv_scales,
            self.shape[:2], int(k))
        if nms_iou is not None:
            valid = valid & nms_device(rects, scores, valid, float(nms_iou))
        sel = valid[0].cpu().numpy()
        out = Boxes(rects[0].cpu().numpy()[sel])
        out.set_field("scores", scores[0].cpu().numpy()[sel])
        return out

    # -- files -----------------------------------------------------------------
    @staticmethod
    def from_message(msg: Dict, device=None) -> "Model":
        o = msg["channel_opts"]
        model = Model(msg["shape"], dict(shrink=o["shrink"],
                                         n_per_oct=o["n_per_oct"],
                                         smooth=o["smooth"],
                                         channels=o["func"]), device=device)
        for tree, theta in zip(msg["classifier"], msg["theta"]):
            model.append(stage_from_fields(tree), theta)
        return model

    def to_message(self) -> Dict:
        o = self.channel_opts
        return dict(shape=list(self.shape),
                    channel_opts=dict(shrink=int(o["shrink"]),
                                      n_per_oct=int(o["n_per_oct"]),
                                      smooth=int(o["smooth"]),
                                      func=o["channels"].name),
                    classifier=[stage_to_fields(s) for s in self.stages],
                    theta=np.asarray(self.theta, np.float32))

    def save(self, filename: str) -> None:
        model_io.write_model_file(filename, self.to_message())

    @staticmethod
    def load(filename: str, device=None) -> "Model":
        return Model.from_message(model_io.read_model_file(filename),
                                  device=device)


def load(filename: str, device=None) -> Model:
    """Load a model file written by this package or the JAX package; the
    model runs on ``device`` (the card when None)."""
    return Model.load(filename, device=device)


def detect_multi(models, image, response_scale=None, device=None) -> Boxes:
    """Several models over one shared channel canvas of ``image``.

    The canvas is planned from the elementwise-minimum window, so every
    model's levels exist; each model scans it with kernel B4 under its own
    window grid and valid mask.  Scores are scaled per model by
    ``response_scale`` and boxes carry a 'label' field with the model's
    index.  Runs on ``device`` (the first model's when None)."""
    image = as_image(image)
    if response_scale is None:
        response_scale = [1.0] * len(models)
    packed, smooth, cf = shared_plan(models, image.shape)
    if not packed.levels:
        return bbx.empty_boxes(scores=np.empty(0, np.float32),
                               label=np.empty(0, np.int64))
    dev = models[0]._device_for(device)
    canvas = _canvas(image[None], packed, smooth, cf, dev)
    out = []
    for kix, mm in enumerate(models):
        grid = window_grid(packed, mm.shape[:2], dev)
        hs, alive, n_weak = cascade_response(canvas, grid.valid,
                                             mm._operands(dev))
        mm._track_cost(int(n_weak[0]), grid.n_loc)
        rs, cs, scores = _survivors(hs[0], alive[0])
        b = mm._boxes_from_canvas_origins(
            rs, cs, scores * float(response_scale[kix]), packed,
            grid.level_id_np, grid.inv_scales_np)
        b.set_field("label", np.full(len(b), kix, dtype=np.int64))
        out.append(b)
    return bbx.concatenate(out, ["scores", "label"])
