"""The synthetic training datasets: squares on noise, and harder scenes.

The port's own copy of the generators of ``waldboost_tpu/utils.py``
(``fake_data_generator``, ``scene_generator``), pure numpy.  The random-draw
order of each generator defines its dataset, so the frames and ground truth
are the JAX package's, bitwise, for the same seed.
"""

from __future__ import annotations

import numpy as np

from . import boxes as bbx
from . import groundtruth

__all__ = ["fake_data_generator", "scene_generator"]

_SCENE_HW = (256, 256)


def _paint_scene(rng: np.random.RandomState):
    """One synthetic scene: up to one bright square over scaled noise.

    The draw order (object count; per object: side, x, y, intensity; then
    the noise field and its global gain) defines the dataset and must never
    change.
    """
    h, w = _SCENE_HW
    field = np.zeros((h, w), np.float32)
    rects = []
    for _ in range(rng.randint(2)):
        side = rng.randint(30, 60)
        x0 = rng.randint(w - side)
        y0 = rng.randint(h - side)
        gain = rng.uniform(0.2, 1)
        field[y0:y0 + side, x0:x0 + side] += gain
        # ground truth is the square dilated by 5 px, YXYX
        rects.append((y0 - 5, x0 - 5, y0 + side + 5, x0 + side + 5))
    field += rng.rand(h, w) * 0.3 * rng.rand()
    image = (np.clip(field, 0.0, 1.0) * 255).astype(np.uint8)
    rects = np.asarray(rects, np.float32) if rects else np.empty((0, 4))
    return image, rects


def fake_data_generator(seed=None):
    """Infinite synthetic dataset: bright squares on noise, 256x256 uint8,
    with YXYX ground truth.  Yields ``{"image", "groundtruth_boxes"}`` dicts
    (the input of :func:`waldboost_tpu_torch.train`)."""
    rng = np.random.RandomState(seed)
    while True:
        image, rects = _paint_scene(rng)
        gt = groundtruth.bbox_list(rects,
                                   format=groundtruth.RectFormat.YXYX)
        yield dict(image=np.atleast_2d(image), groundtruth_boxes=gt)


def scene_generator(seed=None, hw=(256, 256), max_objects=3, octaves=3,
                    base_side=18, aspect=(0.7, 1.45), p_ignore=0.15,
                    clutter=5, noise=0.3):
    """A harder synthetic dataset than :func:`fake_data_generator`: bright
    rectangles over ``octaves`` octaves of size and a range of aspect
    ratios, ignore-flagged instances, and textured clutter that is never
    annotated, over scaled noise.  Yields ``{"image", "groundtruth_boxes"}``
    dicts whose boxes carry an 'ignore' field."""
    rng = np.random.RandomState(seed)
    h, w = hw
    while True:
        field = np.zeros((h, w), np.float32)
        rects, ignore = [], []
        # textured clutter: stripe, ramp and blob patches, never annotated
        for _ in range(rng.randint(clutter + 1)):
            side = rng.randint(12, max(h, w) // 3)
            cw = max(int(side * rng.uniform(*aspect)), 4)
            y0 = rng.randint(max(h - side, 1))
            x0 = rng.randint(max(w - cw, 1))
            kind = rng.randint(3)
            amp = rng.uniform(0.1, 0.45)
            yy, xx = np.mgrid[0:side, 0:cw]
            if kind == 0:      # diagonal stripes
                tex = 0.5 * (1 + np.sin((xx + yy) * (2 * np.pi /
                                                     rng.randint(4, 16))))
            elif kind == 1:    # horizontal ramp
                tex = xx / max(cw - 1, 1)
            else:              # blob (radial falloff)
                cy, cx = side / 2, cw / 2
                tex = np.clip(1 - np.hypot(yy - cy, xx - cx)
                              / max(cy, cx), 0, 1)
            field[y0:y0 + side, x0:x0 + cw] += amp * tex.astype(np.float32)
        # objects: bright rectangles over several octaves of size
        for _ in range(rng.randint(max_objects + 1)):
            octv = rng.randint(octaves)
            side = int(base_side * 2 ** (octv + rng.uniform(0, 1)))
            ar = rng.uniform(*aspect)
            ow = max(int(side * ar), 6)
            if side >= h - 1 or ow >= w - 1:
                continue
            y0 = rng.randint(h - side)
            x0 = rng.randint(w - ow)
            gain = rng.uniform(0.25, 1)
            field[y0:y0 + side, x0:x0 + ow] += gain
            rects.append((x0 - 5, y0 - 5, x0 + ow + 5, y0 + side + 5))
            # truncated or marginal instances are flagged ignore
            ignore.append(1 if rng.rand() < p_ignore else 0)
        field += rng.rand(h, w) * noise * rng.rand()
        image = (np.clip(field, 0.0, 1.0) * 255).astype(np.uint8)
        rects = np.asarray(rects, np.float32) if rects \
            else np.empty((0, 4), np.float32)
        gt = bbx.Boxes(rects, ignore=np.asarray(ignore, np.int32)
                       if ignore else np.empty(0, np.int32))
        yield dict(image=image, groundtruth_boxes=gt)
