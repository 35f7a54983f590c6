"""Static packed-pyramid planning (host side, numpy).

Counterpart of ``waldboost_tpu/packing.py`` with identical geometry: every
pyramid level is placed into one channel canvas, so the whole multi-scale
detection runs as one pass of each kernel and the port's canvases compare
directly with the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .channels import Level, pyramid_plan

__all__ = ["PackedLevel", "PackedPyramidPlan"]


#: canvas widths are multiples of this; the layout search tries 16 of them
LANE_ALIGN = 128
#: seeded random stacked packings tried per canvas width
PACK_TRIALS = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PackedLevel:
    level: Level
    plan_index: int  # index into the full pyramid plan
    y: int           # canvas offset of this level's channel tensor
    x: int
    band: int = -1   # shelf (horizontal strip) id
    col: int = -1    # column id within the shelf (stacked levels share one)


@dataclasses.dataclass(frozen=True)
class PackedPyramidPlan:
    """Shelf-packed layout of all pyramid levels into one (C, H, W) canvas.

    Levels are separated by at least ``2*ceil(halo/shrink)`` (and 2) channel
    pixels so their reflect halos never overlap; the canvas carries a margin
    so edge levels have halo room too.  Window origins outside a level are
    dead in :meth:`valid_mask`.
    """

    levels: Tuple[PackedLevel, ...]
    canvas_h: int
    canvas_w: int
    shrink: int = 1
    halo: int = 0
    window: Tuple[int, int] = (0, 0)
    bands: Tuple[Tuple[int, int], ...] = ()

    @staticmethod
    def build(plan: Sequence[Level], window: Tuple[int, int],
              halo: int = 0, shrink: int = 1) -> "PackedPyramidPlan":
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
            return PackedPyramidPlan(levels=(), canvas_h=max(m + 1, 8),
                                     canvas_w=max(n + 1, LANE_ALIGN),
                                     shrink=shrink, halo=halo, window=(m, n))
        order = sorted(range(len(usable)),
                       key=lambda i: -usable[i][1].out_height)

        def needs(i):
            lv = usable[i][1]
            return (_round_up(lv.out_height + gap_y, align_y),
                    lv.out_width + gap_x)

        def shelf_pack(canvas_w: int):
            # first-fit-decreasing-height shelves
            placed: Dict[int, PackedLevel] = {}
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
                placed[i] = PackedLevel(level=lv, plan_index=pi, y=home[0],
                                        x=home[2], band=home[3], col=i)
                home[2] += w_need
            canvas_h = _round_up(shelves[-1][0] + shelves[-1][1] + margin, 8)
            return placed, canvas_h, tuple(bands)

        def stack_pack(canvas_w: int, pack_order, stack_bias: float):
            # guillotine shelves -> columns -> vertical stacks of levels
            placed: Dict[int, PackedLevel] = {}
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
                placed[i] = PackedLevel(level=lv, plan_index=pi, y=y, x=x,
                                        band=s["band"], col=c["id"])
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
        ordered = tuple(placed[i] for i in range(len(usable)))
        return PackedPyramidPlan(levels=ordered, canvas_h=canvas_h,
                                 canvas_w=canvas_w, shrink=shrink, halo=halo,
                                 window=(m, n), bands=bands)

    def image_canvas_shape(self) -> Tuple[int, int]:
        return self.canvas_h * self.shrink, self.canvas_w * self.shrink

    def stencil_border_mask(self) -> np.ndarray:
        """Image-space bool mask: True strictly inside each level (1px ring
        excluded) — the FPGA stencils' zero-border convention."""
        H, W = self.image_canvas_shape()
        mask = np.zeros((H, W), bool)
        s = self.shrink
        for pl in self.levels:
            y, x = pl.y * s, pl.x * s
            h, w = pl.level.height, pl.level.width
            if h > 2 and w > 2:
                mask[y + 1:y + h - 1, x + 1:x + w - 1] = True
        return mask

    def smooth_interior_mask(self) -> np.ndarray:
        """Channel-space bool mask: True strictly inside each level's channel
        rect (1px ring excluded) — the per-level smooth's zero border."""
        mask = np.zeros((self.canvas_h, self.canvas_w), bool)
        for pl in self.levels:
            h, w = pl.level.out_height, pl.level.out_width
            if h > 2 and w > 2:
                mask[pl.y + 1:pl.y + h - 1, pl.x + 1:pl.x + w - 1] = True
        return mask

    def valid_mask(self, window: Tuple[int, int]) -> np.ndarray:
        """Bool mask over canvas window origins: True where the origin
        belongs to some level's origin grid."""
        m, n = window
        gu, gv = max(self.canvas_h - m, 0), max(self.canvas_w - n, 0)
        mask = np.zeros((gu, gv), bool)
        for pl in self.levels:
            lv = pl.level
            mask[pl.y:pl.y + max(lv.out_height - m, 0),
                 pl.x:pl.x + max(lv.out_width - n, 0)] = True
        return mask

    def level_maps(self, window: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(level_id, inv_scale) maps over canvas origins; level_id is -1
        outside any level."""
        m, n = window
        gu, gv = max(self.canvas_h - m, 0), max(self.canvas_w - n, 0)
        level_id = np.full((gu, gv), -1, np.int32)
        for i, pl in enumerate(self.levels):
            lv = pl.level
            level_id[pl.y:pl.y + max(lv.out_height - m, 0),
                     pl.x:pl.x + max(lv.out_width - n, 0)] = i
        return level_id, np.array([1.0 / pl.level.scale
                                   for pl in self.levels], np.float32)


@functools.lru_cache(maxsize=64)
def _packed_plan_cached(h: int, w: int, shrink: int, n_per_oct: int,
                        window: Tuple[int, int],
                        halo: int = 0) -> PackedPyramidPlan:
    plan = pyramid_plan(h, w, shrink, n_per_oct)
    return PackedPyramidPlan.build(plan, window, halo=halo, shrink=shrink)


def _band_rows(packed: PackedPyramidPlan, he2: int, pr: int, PH: int):
    """The plane-row band partition of the packed canvas.

    Returns ``[(ys, pitch, [(li, top, col), ...]), ...]`` sorted by band
    start: ``ys``/``pitch`` tile ``[0, PH)`` exactly (the first band absorbs
    the top rim, the last extends to PH), ``top`` is the level's row offset
    within its band and ``col`` groups vertically stacked levels.
    """
    if packed.bands:
        by_band: Dict[int, List[Tuple[int, int, int]]] = {}
        for li, pl in enumerate(packed.levels):
            y0 = packed.bands[pl.band][0]
            by_band.setdefault(pl.band, []).append(
                (li, pl.y - y0, pl.col if pl.col >= 0 else li))
        starts = sorted((packed.bands[bi][0] - he2, bi) for bi in by_band)
        groups = [(r0, by_band[bi]) for r0, bi in starts]
    else:
        by_y: Dict[int, List[Tuple[int, int, int]]] = {}
        for li, pl in enumerate(packed.levels):
            by_y.setdefault(pl.y - he2, []).append((li, 0, li))
        groups = sorted(by_y.items())
    out = []
    for si, (r0, lis) in enumerate(groups):
        nxt = groups[si + 1][0] + pr if si + 1 < len(groups) else PH
        rr = r0 + pr
        lead = rr if si == 0 and rr > 0 else 0
        ys = rr - lead
        pitch = nxt - ys
        out.append((ys, pitch,
                    [(li, top + (lead if si == 0 else 0), col)
                     for li, top, col in lis]))
    return out
