"""Ground-truth I/O: rect format conversion and the bbGt v3 reader.

The port's own copy of ``waldboost_tpu/groundtruth.py`` (Piotr's Toolbox
bbGt format, 12-field lines), with the same semantics.
"""

from __future__ import annotations

import enum

import numpy as np

from .boxes import Boxes

__all__ = ["RectFormat", "bbox_list", "read_bbgt"]


class RectFormat(enum.IntEnum):
    XYWH = 0  # [xmin, ymin, width, height]
    XYXY = 1  # [xmin, ymin, xmax, ymax]
    YXYX = 2  # [ymin, xmin, ymax, xmax]


def bbox_list(rects: np.ndarray, format: RectFormat = RectFormat.XYXY,
              **fields) -> Boxes:
    """A Boxes list of (N, 4) rects in the given format."""
    if not isinstance(rects, np.ndarray):
        raise ValueError("bbox_list expects an ndarray of rects, got "
                         f"{type(rects).__name__}")
    if rects.size == 0:
        rects = rects.reshape(0, 4)
    if rects.ndim != 2 or rects.shape[1] != 4:
        raise ValueError(f"bbox_list expects an (N, 4) rect array, got shape {rects.shape}")
    if format != RectFormat.XYXY:
        a, b, c, d = np.split(rects, 4, axis=1)
        if format == RectFormat.XYWH:
            rects = np.hstack([a, b, a + c, b + d])
        elif format == RectFormat.YXYX:
            rects = np.hstack([b, a, d, c])
    return Boxes(rects.astype("f"), **fields)


def read_bbgt(filename: str) -> Boxes:
    """Ground truth of a bbGt v3 file."""
    with open(filename, "r") as f:
        signature = f.readline()
        if not signature.startswith("% bbGt version=3"):
            raise ValueError(f"not a bbGt v3 annotation file: {filename!r}")
        rects, ignore, labels = [], [], []
        for line in f:
            elms = line.strip().split()
            if not elms:
                continue
            if len(elms) != 12:
                raise ValueError(f"malformed bbGt line (expected 12 fields, "
                                 f"got {len(elms)}): {line.strip()!r}")
            labels.append(elms[0])
            rects.append(tuple(map(float, elms[1:5])))
            ignore.append(int(elms[10]))
    if not rects:
        return bbox_list(np.empty((0, 4), "f"), format=RectFormat.XYWH,
                         ignore=np.empty(0, "i"), labels=np.empty(0, "<U1"))
    return bbox_list(np.array(rects, "f"), format=RectFormat.XYWH,
                     ignore=np.array(ignore, "i"), labels=np.array(labels))
