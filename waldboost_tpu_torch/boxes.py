"""Host-side box lists: rectangles with named per-box fields (numpy).

The port's own copy of ``waldboost_tpu/boxes.py`` (``Boxes``,
``empty_boxes``, ``concatenate``, ``iou``, ``iou_matrix``,
``non_max_suppression``, ``sort_by_field``) with the same semantics.  Box
lists are ragged, so they live on the host at the API boundary; the
fixed-shape device NMS is :func:`waldboost_tpu_torch.ops.nms.nms`.

Rect format is XYXY float32: ``[xmin, ymin, xmax, ymax]``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["Boxes", "concatenate", "empty_boxes", "iou", "iou_matrix",
           "non_max_suppression", "sort_by_field"]


class Boxes:
    """(N, 4) XYXY float32 rectangles plus named per-box fields."""

    def __init__(self, rects, **fields):
        rects = np.atleast_2d(np.asarray(rects, dtype=np.float32))
        if rects.size == 0:
            rects = rects.reshape(0, 4)
        if rects.ndim != 2 or rects.shape[1] != 4:
            raise ValueError(f"Rects must have shape (N, 4), got {rects.shape}")
        self._rects = rects
        self._fields: Dict[str, np.ndarray] = {}
        for name, value in fields.items():
            self.set_field(name, value)

    def get(self) -> np.ndarray:
        return self._rects

    def num_boxes(self) -> int:
        return self._rects.shape[0]

    def __len__(self) -> int:
        return self._rects.shape[0]

    def __bool__(self) -> bool:
        return self._rects.shape[0] > 0

    def field_names(self) -> List[str]:
        return list(self._fields)

    def has_field(self, name: str) -> bool:
        return name in self._fields

    def get_field(self, name: str) -> np.ndarray:
        if name not in self._fields:
            raise KeyError(f"Field '{name}' does not exist")
        return self._fields[name]

    def set_field(self, name: str, value) -> None:
        value = np.asarray(value)
        if value.shape[:1] != (len(self),):
            raise ValueError(
                f"Field '{name}' first dimension {value.shape[:1]} does not "
                f"match number of boxes ({len(self)})")
        self._fields[name] = value

    add_field = set_field

    def remove_field(self, name: str) -> None:
        del self._fields[name]

    def area(self) -> np.ndarray:
        x1, y1, x2, y2 = self._rects.T
        return np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)

    def normalized(self, scale: float = 1.0) -> "Boxes":
        """A copy with every coordinate multiplied by ``scale`` (float32)."""
        out = Boxes(self._rects * np.float32(scale))
        for name, value in self._fields.items():
            out.set_field(name, value)
        return out

    def __getitem__(self, idx) -> "Boxes":
        if np.isscalar(idx) or (isinstance(idx, np.ndarray) and idx.ndim == 0):
            idx = np.array([idx])
        out = Boxes(self._rects[idx])
        for name, value in self._fields.items():
            out.set_field(name, value[idx])
        return out

    def copy(self) -> "Boxes":
        out = Boxes(self._rects.copy())
        for name, value in self._fields.items():
            out.set_field(name, value.copy())
        return out

    def __repr__(self) -> str:
        return f"Boxes(n={len(self)}, fields={self.field_names()})"


def empty_boxes(**fields) -> Boxes:
    """An empty box list with the given (empty) fields."""
    out = Boxes(np.empty((0, 4), np.float32))
    for name, value in fields.items():
        out.set_field(name, np.asarray(value))
    return out


def concatenate(box_lists: Sequence[Boxes],
                fields: Optional[Iterable[str]] = None) -> Boxes:
    """Concatenate box lists, keeping ``fields`` (default: the fields every
    list has)."""
    box_lists = [b for b in box_lists if b is not None]
    if not box_lists:
        return empty_boxes()
    if fields is None:
        names = set(box_lists[0].field_names())
        for b in box_lists[1:]:
            names &= set(b.field_names())
        fields = sorted(names)
    out = Boxes(np.concatenate([b.get() for b in box_lists], axis=0))
    for name in fields:
        out.set_field(name, np.concatenate([b.get_field(name)
                                            for b in box_lists], axis=0))
    return out


def iou(a: Boxes, b: Boxes) -> np.ndarray:
    """Pairwise IoU matrix of shape ``(len(a), len(b))``."""
    return iou_matrix(a.get(), b.get())


def iou_matrix(ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """IoU between (N, 4) and (M, 4) XYXY rect arrays, float32."""
    ra = np.asarray(ra, np.float32).reshape(-1, 4)
    rb = np.asarray(rb, np.float32).reshape(-1, 4)
    x1 = np.maximum(ra[:, None, 0], rb[None, :, 0])
    y1 = np.maximum(ra[:, None, 1], rb[None, :, 1])
    x2 = np.minimum(ra[:, None, 2], rb[None, :, 2])
    y2 = np.minimum(ra[:, None, 3], rb[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area_a = np.maximum(ra[:, 2] - ra[:, 0], 0) \
        * np.maximum(ra[:, 3] - ra[:, 1], 0)
    area_b = np.maximum(rb[:, 2] - rb[:, 0], 0) \
        * np.maximum(rb[:, 3] - rb[:, 1], 0)
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out.astype(np.float32)


def non_max_suppression(boxes: Boxes, iou_threshold: float = 0.5,
                        score_field: str = "scores") -> Boxes:
    """Greedy NMS by descending score (stable: the lower index wins a tie):
    keeps the best box of every cluster overlapping with IoU > threshold.
    The kept boxes are returned in their input order."""
    n = len(boxes)
    if n == 0:
        return boxes
    scores = np.asarray(boxes.get_field(score_field)).reshape(-1)
    order = np.argsort(-scores, kind="stable")
    rects = np.asarray(boxes.get(), np.float32)[order].reshape(-1, 4)
    # one IoU row per kept box, not the n x n matrix
    area = np.maximum(rects[:, 2] - rects[:, 0], 0) \
        * np.maximum(rects[:, 3] - rects[:, 1], 0)
    kept = []
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if suppressed[i]:
            continue
        kept.append(i)
        suppressed[i] = True
        rest = ~suppressed
        if not rest.any():
            break
        rr = rects[rest]
        x1 = np.maximum(rects[i, 0], rr[:, 0])
        y1 = np.maximum(rects[i, 1], rr[:, 1])
        x2 = np.minimum(rects[i, 2], rr[:, 2])
        y2 = np.minimum(rects[i, 3], rr[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        union = area[i] + area[rest] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou_row = np.where(union > 0, inter / union, 0.0)
        sup = np.zeros(n, bool)
        sup[rest] = iou_row.astype(np.float32) > iou_threshold
        suppressed |= sup
    return boxes[np.sort(order[np.array(kept, int)])]


def sort_by_field(boxes: Boxes, field: str, descending: bool = False) -> Boxes:
    values = np.asarray(boxes.get_field(field)).reshape(len(boxes), -1)[:, 0]
    order = np.argsort(values, kind="stable")
    if descending:
        order = order[::-1]
    return boxes[order]
