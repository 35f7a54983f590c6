"""Training-sample mining: window crops, IoU labeling, the bootstrapped pool.

Counterpart of ``waldboost_tpu/samples.py``.  The host keeps the ragged
bookkeeping (box lists, per-image quotas, the seeded random draws of
labeling, in JAX's order); the device scans a batch of frames with the
model's current cascade (``Model.scan_packed_batch``: kernels B1 and B2,
or B5 for the FPGA channels, then B6), gathers the kept windows' crops and
scores, and rescores the pool (``Model.predict``).

While a torch profiler runs, the steps run in ``wb.train.*`` spans:
``mine`` (canvas and B6), ``label`` (host labeling), ``gather`` (crops and
scores to the host) and ``rescore``.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from . import boxes as bbx
from .boxes import Boxes
from .canvas import span
from .mining import gather_windows_scores
from .model import Model

__all__ = [
    "gather_samples",
    "select_candidates",
    "SampleLabel",
    "label_boxes",
    "get_regression_target",
    "get_samples_from_image",
    "get_samples_from_images",
    "mine_labeled_windows",
    "batched_records",
    "SamplePool",
]


def gather_samples(chns: np.ndarray, rs: np.ndarray, cs: np.ndarray,
                   shape: tuple) -> np.ndarray:
    """Crop windows of ``shape`` = (win_h, win_w, C) at origins ``(rs, cs)``
    from an HWC channel array on the host (the mining path crops on the
    device: :mod:`waldboost_tpu_torch.mining`).  No range checks."""
    if rs.size != cs.size:
        raise ValueError("Sizes of 'rs' and 'cs' must match")
    win_h, win_w = shape[0], shape[1]
    chns = np.asarray(chns)
    if rs.size == 0:
        return np.empty((0,) + tuple(shape), dtype=chns.dtype)
    return np.stack([chns[r:r + win_h, c:c + win_w, ...]
                     for r, c in zip(rs, cs)])


def select_candidates(condition: np.ndarray, max_candidates: int,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """At most ``max_candidates`` indices where condition is True; random
    subsample (with replacement, ``Generator.choice``'s default) when
    more."""
    idx = np.flatnonzero(condition)
    if idx.size <= max_candidates:
        return idx
    rng = rng or np.random.default_rng()
    return rng.choice(idx, max_candidates)


class SampleLabel:
    TRUE_POSITIVE = 1
    FALSE_POSITIVE = -1
    IGNORE = 0


def _match_to_groundtruth(dt_boxes: Boxes, gt_boxes: Boxes):
    """Assign each detection its best-IoU ground-truth instance.

    Returns ``(best_iou, matched_gt, matched_is_ignore)`` — per-detection
    max IoU, argmax instance index, and whether that instance carries the
    dataset's 'ignore' flag (absent flag == all zeros)."""
    overlap = bbx.iou(dt_boxes, gt_boxes)
    best_iou = overlap.max(axis=1)
    matched_gt = overlap.argmax(axis=1).astype(np.int32)
    if gt_boxes.has_field("ignore"):
        gt_ignore = np.asarray(gt_boxes.get_field("ignore")).reshape(-1)
    else:
        gt_ignore = np.zeros(len(gt_boxes))
    return best_iou, matched_gt, gt_ignore[matched_gt]


def label_boxes(dt_boxes: Optional[Boxes], gt_boxes: Optional[Boxes],
                min_tp_iou: float = 0.7, max_fp_iou: float = 0.3,
                max_tp_candidates: int = 100, max_fp_candidates: int = 100,
                rng: Optional[np.random.Generator] = None) -> None:
    """Label detections TP/FP/IGNORE by IoU against ground truth; mutates
    ``dt_boxes`` adding 'instance_id' and 'tp_label'.  IoU above
    ``min_tp_iou`` against a non-ignored instance is TP, below
    ``max_fp_iou`` against everything is FP, the rest (and detections on
    ignored instances) stay IGNORE; both classes are randomly capped."""
    if dt_boxes is None:
        return
    n_det = len(dt_boxes)
    labels = np.full(n_det, SampleLabel.IGNORE, np.int32)
    if gt_boxes is not None and len(gt_boxes) > 0:
        best_iou, matched_gt, matched_is_ignore = \
            _match_to_groundtruth(dt_boxes, gt_boxes)
        # rng draw order (FP selection, then TP) is part of the observable
        # behavior under a seeded generator — keep it
        fp_pick = select_candidates(best_iou < max_fp_iou,
                                    max_fp_candidates, rng)
        tp_pick = select_candidates(
            (best_iou > min_tp_iou) & (matched_is_ignore == 0),
            max_tp_candidates, rng)
        labels[tp_pick] = SampleLabel.TRUE_POSITIVE
    else:
        # background image: every window is a negative candidate
        matched_gt = np.full(n_det, -1, np.int32)
        fp_pick = select_candidates(np.ones(n_det, bool),
                                    max_fp_candidates, rng)
    labels[fp_pick] = SampleLabel.FALSE_POSITIVE
    dt_boxes.set_field("instance_id", matched_gt)
    dt_boxes.set_field("tp_label", labels)


def get_regression_target(dt_boxes: Boxes, gt_boxes: Boxes) -> None:
    """Attach per-detection box deltas against the assigned ground-truth
    instance (a bbox-regression hook no training path uses)."""
    if not dt_boxes.has_field("instance_id"):
        raise ValueError("'instance_id' field is missing")
    gt_idx = np.asarray(dt_boxes.get_field("instance_id"), int)
    regression_target = dt_boxes.get() - gt_boxes[gt_idx].get()
    dt_boxes.add_field("regression_target", regression_target)


def _label_survivors(model: Model, packed, rs, cs, gt_boxes, tp, fp,
                     rng, **kwargs):
    """Per-level labeling and candidate caps of one image's scan survivors,
    levels in plan order and survivors row-major within a level (the
    order of the seeded draws).  Returns the selected Boxes, with canvas
    'row'/'col' fields for the crop and score gather."""
    m, n, _ = model.shape
    level_id_map, _ = packed.level_maps((m, n))
    lid = level_id_map[rs, cs]
    pending = []
    for i, pl in enumerate(packed.levels):
        sel = np.flatnonzero(lid == i)
        if sel.size == 0:
            continue
        r = rs[sel] - pl.y
        c = cs[sel] - pl.x
        dt_boxes = model.get_boxes(r, c, pl.level.scale)
        dt_boxes.set_field("row", rs[sel])   # canvas coordinates for crops
        dt_boxes.set_field("col", cs[sel])
        label_boxes(dt_boxes, gt_boxes, rng=rng, **kwargs)
        tp_label = dt_boxes.get_field("tp_label")
        selector = np.logical_or(
            np.logical_and(tp_label == SampleLabel.TRUE_POSITIVE, bool(tp)),
            np.logical_and(tp_label == SampleLabel.FALSE_POSITIVE, bool(fp)))
        sample_indices = np.flatnonzero(selector)
        dt_boxes = dt_boxes[sample_indices]
        if len(dt_boxes) == 0:
            continue
        pending.append(dt_boxes)
    return pending


def get_samples_from_image(model: Model, image, gt_boxes: Optional[Boxes],
                           tp=True, fp=True, rng=None, **kwargs):
    """Scan the pyramid, label the surviving windows, crop their channels.
    Yields labeled Boxes with 'scores', 'tp_label', 'samples' fields per
    level (the batched path on one image)."""
    rec = {"image": np.asarray(image), "groundtruth_boxes": gt_boxes}
    for _i, b in get_samples_from_images(model, [rec], tp=tp, fp=fp,
                                         rng=rng, **kwargs):
        yield b


def mine_labeled_windows(model: Model, records, tp=True, fp=True,
                         rng=None, **kwargs):
    """Scan and label a batch; the kept windows' crops stay on the device.

    One canvas and one cascade launch scan the batch (padded to a power of
    two by repeating its last frame, as JAX pads it, so the eval-cost
    counters match); labeling runs per image in record order with the
    seeded generator.  Returns None or ``(pend, samples, scores)``: ``pend``
    is a list of ``(record_index, dt_boxes)`` and row ``j`` of the (K, m,
    n, C) crops and (K,) scores belongs to the ``j``-th box of ``pend`` in
    concatenation order.
    """
    images = np.stack([np.asarray(r["image"]) for r in records])
    B = images.shape[0]
    Bp = 1 << (B - 1).bit_length()
    if Bp > B:
        images = np.concatenate([images,
                                 np.repeat(images[-1:], Bp - B, axis=0)])
    with span("wb.train.mine"):
        scan = model.scan_packed_batch(images, n_real=B)
    if scan is None:
        return None
    canvas, hs, packed, per_image = scan
    pend = []  # (record index, Boxes)
    with span("wb.train.label"):
        for i, (rec, (rs, cs)) in enumerate(zip(records, per_image)):
            if rs.size == 0:
                continue
            for b in _label_survivors(model, packed, rs, cs,
                                      rec.get("groundtruth_boxes"), tp, fp,
                                      rng, **kwargs):
                pend.append((i, b))
    if not pend:
        return None
    bs = np.concatenate([np.full(len(b), i, np.int64) for i, b in pend])
    rows = np.concatenate([b.get_field("row").reshape(-1) for _, b in pend])
    cols = np.concatenate([b.get_field("col").reshape(-1) for _, b in pend])
    idx = [torch.from_numpy(a.astype(np.int64)).to(canvas.device)
           for a in (bs, rows, cols)]
    samples, scores = gather_windows_scores(canvas, hs, *idx,
                                            model.shape[:2])
    return pend, samples, scores


def get_samples_from_images(model: Model, records, tp=True, fp=True,
                            rng=None, **kwargs):
    """Batched :func:`get_samples_from_image` over same-shape images:
    :func:`mine_labeled_windows`, then the kept crops and scores are copied
    to the host as 'samples'/'scores' box fields.  Yields
    ``(record_index, dt_boxes)`` pairs.
    """
    mined = mine_labeled_windows(model, records, tp=tp, fp=fp, rng=rng,
                                 **kwargs)
    if mined is None:
        return
    pend, samples_dev, scores_dev = mined
    with span("wb.train.gather"):
        samples = samples_dev.cpu().numpy()
        scores = scores_dev.cpu().numpy().astype(np.float32)
    off = 0
    for i, dt_boxes in pend:
        kk = len(dt_boxes)
        dt_boxes.set_field("samples", samples[off:off + kk])
        dt_boxes.set_field("scores", scores[off:off + kk])
        off += kk
        yield i, dt_boxes


def batched_records(iterable: Iterable[dict], batch: int):
    """Group a record stream into same-image-shape batches of up to
    ``batch`` (a shape change flushes the current group early; record
    order is preserved exactly)."""
    group = []
    shape = None
    for rec in iterable:
        s = np.asarray(rec["image"]).shape
        if group and (s != shape or len(group) >= batch):
            yield group
            group = []
        shape = s
        group.append(rec)
        if len(group) >= batch:
            yield group
            group = []
    if group:
        yield group


class SamplePool:
    """Bootstrapped pool of labeled training windows (host numpy).

    Each ``update`` rescores the pool with the grown cascade on the model's
    device, drops rejected samples, and mines new images until the tp/fp
    quotas are refilled, so the false positives stay hard."""

    def __init__(self, min_tp: int = 1000, min_fp: int = 1000,
                 logger_: Optional[logging.Logger] = None,
                 seed: Optional[int] = None, mine_batch: int = 8, **kwargs):
        self.samples: Optional[Boxes] = None
        self.min_tp = min_tp
        self.min_fp = min_fp
        self.label_boxes_args = kwargs
        self.logger = logger_ or logging.getLogger("SamplePool")
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        #: images scanned per mining batch (one canvas and one cascade
        #: launch per batch; 1 scans image by image)
        self.mine_batch = max(int(mine_batch), 1)

    def update(self, model: Model, iterable: Iterable[dict]) -> None:
        """One bootstrap round: rescore the pool with the grown cascade,
        drop rejected windows, then mine images until both quotas refill."""
        self.update_scores(model)
        self.remove_low_scoring()
        need = self.deficit()
        if not (need["tp"] or need["fp"]):
            return
        parts = ([] if self.samples is None else [self.samples])
        parts += list(self._mine(model, iterable, need))
        if len(parts) > (self.samples is not None):
            self.samples = bbx.concatenate(parts)

    def deficit(self) -> dict:
        """How many tp/fp samples are missing vs the quotas (>= 0 each)."""
        stats = self.pool_stats()
        self.logger.log(15, "pool fill tp=%d/%d fp=%d/%d",
                        stats["num_tp"], self.min_tp,
                        stats["num_fp"], self.min_fp)
        return {"tp": max(self.min_tp - stats["num_tp"], 0),
                "fp": max(self.min_fp - stats["num_fp"], 0)}

    def _mine(self, model: Model, iterable: Iterable[dict], need: dict):
        """Yield labeled survivor boxes from ``mine_batch``-image groups,
        decrementing ``need`` in place, until both deficits reach zero (or
        the stream ends).  Which classes to collect is re-decided per group
        so a satisfied quota stops contributing mid-run."""
        for group in batched_records(iterable, self.mine_batch):
            mined = get_samples_from_images(
                model, group, tp=need["tp"] > 0, fp=need["fp"] > 0,
                rng=self.rng, **self.label_boxes_args)
            for _i, dt_boxes in mined:
                lbl = dt_boxes.get_field("tp_label")
                need["tp"] -= int((lbl == SampleLabel.TRUE_POSITIVE).sum())
                need["fp"] -= int((lbl == SampleLabel.FALSE_POSITIVE).sum())
                yield dt_boxes
            if need["tp"] <= 0 and need["fp"] <= 0:
                return

    def pool_stats(self) -> dict:
        if self.samples is None:
            return dict(num_tp=0, num_fp=0)
        labels = self.samples.get_field("tp_label")
        return dict(num_tp=int((labels == SampleLabel.TRUE_POSITIVE).sum()),
                    num_fp=int((labels == SampleLabel.FALSE_POSITIVE).sum()))

    def print_stats(self) -> None:
        self.logger.info(str(self.pool_stats()))

    def update_scores(self, model: Model) -> None:
        if self.samples is not None and len(self.samples):
            with span("wb.train.rescore"):
                new_scores, _ = model.predict(
                    self.samples.get_field("samples"))
            self.samples.set_field("scores", new_scores)

    def remove_low_scoring(self, min_score: float = -np.inf) -> None:
        if self.samples is not None and len(self.samples):
            mask = self.samples.get_field("scores") > min_score
            self.samples = self.samples[np.flatnonzero(mask)]
            self.logger.log(
                15, "rescore dropped %d of %d pooled samples",
                int((~mask).sum()), mask.size)

    def get_samples(self, label: int) -> Tuple[np.ndarray, np.ndarray]:
        labels = self.samples.get_field("tp_label")
        boxes = self.samples[labels == label]
        X = boxes.get_field("samples")
        H = boxes.get_field("scores").flatten()
        return X.copy(), H.copy()

    def get_true_positives(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.get_samples(label=SampleLabel.TRUE_POSITIVE)

    def get_false_positives(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.get_samples(label=SampleLabel.FALSE_POSITIVE)
