"""The pyramid plan and the packed canvas layout the detector's outputs
are indexed by.

A frozen copy of the serving layout: every pyramid level placed into one
channel canvas by a seeded search over shelf and stacked packings.  The
reference needs it because the detector's top-k breaks ties between equal
scores by flat window-origin index on this canvas, and its boxes map
canvas origins back to image space through each level's placement.
"""

from __future__ import annotations

import functools
import random
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

__all__ = ["Level", "Placed", "Packing", "pyramid_plan", "pack"]

LANE_ALIGN = 128
PACK_TRIALS = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Level(NamedTuple):
    octave: int
    height: int
    width: int
    out_height: int
    out_width: int
    scale: float


class Placed(NamedTuple):
    level: Level
    plan_index: int
    y: int
    x: int


class Packing(NamedTuple):
    levels: Tuple[Placed, ...]
    canvas_h: int
    canvas_w: int

    def valid_mask(self, window: Tuple[int, int]) -> np.ndarray:
        """(GU, GV) bool: origins that lie in some level's origin grid."""
        m, n = window
        gu, gv = max(self.canvas_h - m, 0), max(self.canvas_w - n, 0)
        mask = np.zeros((gu, gv), bool)
        for p in self.levels:
            mask[p.y:p.y + max(p.level.out_height - m, 0),
                 p.x:p.x + max(p.level.out_width - n, 0)] = True
        return mask

    def level_id(self, window: Tuple[int, int]) -> np.ndarray:
        """(GU, GV) int: the level of each origin, -1 outside levels."""
        m, n = window
        gu, gv = max(self.canvas_h - m, 0), max(self.canvas_w - n, 0)
        lid = np.full((gu, gv), -1, np.int64)
        for i, p in enumerate(self.levels):
            lid[p.y:p.y + max(p.level.out_height - m, 0),
                p.x:p.x + max(p.level.out_width - n, 0)] = i
        return lid


@functools.lru_cache(maxsize=None)
def pyramid_plan(h: int, w: int, shrink: int, n_per_oct: int
                 ) -> Tuple[Level, ...]:
    """Every level of an (h, w) frame: octaves halve while both sides are
    at least 8, ``n_per_oct`` scales an octave, sides snapped to the
    shrink."""
    levels: List[Level] = []
    oh, ow, octave = h, w, 0
    factor = 2.0 ** (-1.0 / n_per_oct)
    while oh >= 8 and ow >= 8:
        for i in range(n_per_oct):
            s = factor ** i
            nw = int((ow * s) / shrink) * shrink
            nh = int((oh * s) / shrink) * shrink
            levels.append(Level(octave, nh, nw, nh // shrink, nw // shrink,
                                (nw / w) / shrink))
        oh, ow = oh // 2, ow // 2
        octave += 1
    return tuple(levels)


@functools.lru_cache(maxsize=None)
def pack(plan: Sequence[Level], window: Tuple[int, int], halo: int = 0,
         shrink: int = 1) -> Packing:
    """The canvas placement of every level with an origin grid."""
    m, n = window
    # an even halo gives all four polyphase planes of a level one
    # plane-space placement
    halo = halo + (halo % 2)
    halo_c = -(-halo // shrink)
    gap_y = max(2 * halo_c, 2)
    gap_x = max(2 * halo_c, 2)
    margin = halo_c + (1 if halo > 0 else 0)
    align_y = 8 if shrink == 2 else 1
    margin_y = margin
    if align_y > 1:
        while (margin_y - halo_c) % align_y:
            margin_y += 1
    usable = [(pi, lv) for pi, lv in enumerate(plan)
              if lv.out_height > m and lv.out_width > n]
    if not usable:
        return Packing((), max(m + 1, 8), max(n + 1, LANE_ALIGN))
    order = sorted(range(len(usable)),
                   key=lambda i: -usable[i][1].out_height)

    def needs(i):
        lv = usable[i][1]
        return (_round_up(lv.out_height + gap_y, align_y),
                lv.out_width + gap_x)

    def shelf_pack(canvas_w: int):
        # first-fit-decreasing-height shelves
        placed: Dict[int, Placed] = {}
        shelves: List[List[int]] = []  # [y, height, cur_x, band_id]
        bands: List[Tuple[int, int]] = []
        for i in order:
            pi, lv = usable[i]
            h_need, w_need = needs(i)
            home = None
            for s in shelves:
                if s[2] + w_need <= canvas_w - margin and h_need <= s[1]:
                    home = s
                    break
            if home is None:
                y = (shelves[-1][0] + shelves[-1][1]) if shelves \
                    else margin_y
                home = [y, h_need, margin, len(shelves)]
                shelves.append(home)
                bands.append((y, h_need))
            placed[i] = Placed(lv, pi, home[0], home[2])
            home[2] += w_need
        canvas_h = _round_up(shelves[-1][0] + shelves[-1][1] + margin, 8)
        return placed, canvas_h, tuple(bands)

    def stack_pack(canvas_w: int, pack_order, stack_bias: float):
        # guillotine shelves -> columns -> vertical stacks of levels
        placed: Dict[int, Placed] = {}
        shelves = []
        bands: List[Tuple[int, int]] = []
        for i in pack_order:
            pi, lv = usable[i]
            h_need, w_need = needs(i)
            best_st = None
            best_co = None
            for s in shelves:
                for c in s["cols"]:
                    rem = s["y"] + s["bh"] - c["cy"]
                    if rem >= h_need and c["w"] >= w_need:
                        key = ((c["w"] - w_need) * h_need * stack_bias
                               + (rem - h_need) * w_need * 0.01)
                        if best_st is None or key < best_st[0]:
                            best_st = (key, s, c)
                if (s["cx"] + w_need <= canvas_w - margin
                        and s["bh"] >= h_need):
                    key = (s["bh"] - h_need) * w_need
                    if best_co is None or key < best_co[0]:
                        best_co = (key, s)
            if best_st is not None and (best_co is None
                                        or best_st[0] <= best_co[0]):
                _, s, c = best_st
                y, x = c["cy"], c["x"]
                c["cy"] += h_need
            elif best_co is not None:
                _, s = best_co
                c = {"x": s["cx"], "w": w_need, "cy": s["y"] + h_need,
                     "id": len(s["cols"])}
                y, x = s["y"], s["cx"]
                s["cols"].append(c)
                s["cx"] += w_need
            else:
                y0 = (shelves[-1]["y"] + shelves[-1]["bh"]) if shelves \
                    else margin_y
                s = {"y": y0, "bh": h_need, "cx": margin,
                     "band": len(shelves), "cols": []}
                c = {"x": margin, "w": w_need, "cy": y0 + h_need,
                     "id": 0}
                y, x = y0, margin
                s["cols"].append(c)
                s["cx"] += w_need
                shelves.append(s)
                bands.append((y0, h_need))
            placed[i] = Placed(lv, pi, y, x)
        canvas_h = _round_up(shelves[-1]["y"] + shelves[-1]["bh"]
                             + margin, 8)
        return placed, canvas_h, tuple(bands)

    # many canvas widths; keep the layout with the fewest (128, 256)
    # tiles, ties broken on area.  The stacked packings are a seeded
    # random family, so every process derives the same plan.
    min_w = _round_up(max(lv.out_width for _, lv in usable)
                      + gap_x + 2 * margin, LANE_ALIGN)
    best = None
    for canvas_w in range(min_w, min_w + 16 * LANE_ALIGN, LANE_ALIGN):
        cands = [shelf_pack(canvas_w)]
        rng = random.Random(canvas_w)
        for t in range(PACK_TRIALS):
            pack_order = list(order)
            if t and len(pack_order) > 1:
                for _ in range(rng.randrange(0, 8)):
                    j = rng.randrange(len(pack_order) - 1)
                    pack_order[j], pack_order[j + 1] = \
                        pack_order[j + 1], pack_order[j]
            bias = rng.choice([0.3, 0.5, 1.0, 2.0, 5.0]) if t else 1.0
            cands.append(stack_pack(canvas_w, pack_order, bias))
        for placed, canvas_h, bands in cands:
            tiles = -(-canvas_h // 128) * -(-canvas_w // 256)
            area = canvas_h * canvas_w
            if best is None or (tiles, area) < best[0]:
                best = ((tiles, area), canvas_w, canvas_h, placed, bands)
    _, canvas_w, canvas_h, placed, bands = best
    return Packing(tuple(placed[i] for i in range(len(usable))), canvas_h,
                   canvas_w)

