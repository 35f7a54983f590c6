"""Per-level resize geometry of the polyphase plane canvas (host side).

Counterpart of ``waldboost_tpu/polyphase.py:_ext_pm_taps`` and
``_poly_geom_levels``.  The full-resolution image canvas of a shrink-2
pyramid is stored as its 2x2 polyphase decomposition ``(B, 2, 2, PH, PW)``
with ``planes[b, a, q, i, j] = canvas[2i + a, 2j + q]``.  Each level's
block is ``(2, 2, hq, wq)`` with the (even) reflect halo baked into the
taps, placed at plane row ``pl.y - halo/2`` and column ``pl.x - halo/2``;
gaps stay zero.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .ops.exact import axis_taps_exact, resize_taps64
from .packing import PackedPyramidPlan, _band_rows

__all__ = ["PlaneTables", "plane_tables", "FloatPlaneTables",
           "float_plane_tables", "resize_taps64"]


def _ext_pm_taps(R, size, halo):
    """Reflect-halo row duplication + phase-major regrouping of a tap
    vector (rows of the resize matrix in 2x2-polyphase emission order)."""
    if halo:
        R = np.concatenate([R[halo - 1::-1], R,
                            R[size - 1:size - halo - 1:-1]])
    return np.concatenate([R[halo % 2::2], R[(1 + halo) % 2::2]])


def _octave_layout(image_hw: Tuple[int, int], n_oct: int):
    """``(oct_hw, oct_off, total)``: each octave's shape (the o-fold
    floor-halving of ``image_hw``), its offset in the flattened octave
    buffer, and the buffer's length."""
    oct_hw, oct_off, off = [], [], 0
    h, w = image_hw
    for _ in range(n_oct):
        oct_hw.append((h, w))
        oct_off.append(off)
        off += h * w
        h, w = h // 2, w // 2
    return oct_hw, oct_off, off


def _level_rows(packed: PackedPyramidPlan, he2: int, PH: int):
    """Each level's first plane row: its band start plus its row in the
    band, the placement rule of the JAX plane assembly."""
    return {li: ys + top for ys, _pitch, lis in _band_rows(packed, he2, 0, PH)
            for li, top, _col in lis}


def _poly_geom_levels(packed: PackedPyramidPlan, halo, image_hw):
    """Per-level resize geometry: octave shape, phase-major exact taps
    (integer frac numerators ``frh``/``frw`` over ``den_h``/``den_w``) and
    the block size ``(hq, wq)``.  Octave o's shape is the o-fold
    floor-halving of ``image_hw``."""
    oct_hw = {}
    n_oct = max((pl.level.octave for pl in packed.levels), default=0) + 1
    h, w = image_hw
    for o in range(n_oct):
        oct_hw[o] = (h, w)
        h, w = h // 2, w // 2
    out = []
    for pl in packed.levels:
        lv = pl.level
        oh, ow = oct_hw[lv.octave]
        th = axis_taps_exact(oh, lv.height)
        tw = axis_taps_exact(ow, lv.width)
        i0h, frh = (_ext_pm_taps(t, lv.height, halo) for t in th[:2])
        i0w, frw = (_ext_pm_taps(t, lv.width, halo) for t in tw[:2])
        hq = (lv.height + 2 * halo) // 2
        wq = (lv.width + 2 * halo) // 2
        out.append(dict(oct=lv.octave, oh=oh, ow=ow, i0h=i0h, frh=frh,
                        i0w=i0w, frw=frw, den_h=th[2], den_w=tw[2],
                        hq=hq, wq=wq))
    return out




def div_magic(den: int) -> Tuple[int, int]:
    """``(m, s)`` with ``floor(N / den) == umulhi(2 * N, m) >> s`` for
    every ``N`` in ``[0, 255 * den]``, ``m`` < 2**32 (the plane kernel's
    floor of the 4-corner numerator).

    ``f(N) = floor(2*N*m / 2**(32+s))`` never decreases with ``N``, so it
    equals ``floor(N / den)`` on all of ``[k*den, k*den + den - 1]`` iff it
    does at both ends: checking the 511 ends for k = 0 .. 255 proves the
    whole range.  The smallest ``s`` that passes is taken."""
    if den < 1 or 255 * den >= 2 ** 31:
        raise ValueError(f"denominator {den}: 255*den must be in [1, 2**31)")
    ends = [(k * den, k) for k in range(256)] \
        + [(k * den + den - 1, k) for k in range(255)]
    for s in range(32):
        m = -(-(1 << (31 + s)) // den)
        if m >= 1 << 32:
            break
        if all((n * m) >> (31 + s) == k for n, k in ends):
            return m, s
    raise ValueError(f"denominator {den}: no 32-bit division magic")


#: columns of :attr:`PlaneTables.meta`, one row per level
META_COLS = ("oct_off", "oh", "ow", "hq", "wq", "y0", "x0", "den_h",
             "den_w", "tap_h", "tap_w", "elems", "magic", "shift")
#: columns of :attr:`PlaneTables.tiles` and :attr:`PlaneTables.pieces`
TILE_COLS = ("y0", "x0", "begin", "end")
PIECE_COLS = ("ya", "yb", "xa", "xb", "cmin", "n", "oct_off", "ow", "oh",
              "rbase", "hq", "den_h", "den_w", "jt", "magic", "shift")

#: the plane kernel's tile: rows of the plane canvas, columns (32 lanes x
#: 4 bytes, csrc/planes.cu kTR, kTC)
PLANE_TILE_ROWS = 16
PLANE_TILE_COLS = 128


def v_max(tile_cols: int) -> int:
    """Octave columns one warp's blend row holds (csrc/planes.cu kVMax): a
    level's column step is below 4 octave pixels per pair of outputs."""
    return 4 * tile_cols + 8


@dataclasses.dataclass(frozen=True)
class PlaneTables:
    """Host tables of the plane kernel (ops/planes.py), int32 numpy.

    ``meta`` (L, len(META_COLS)): per level the octave's offset in the
    flattened octave buffer, octave shape, block shape, plane-space
    placement, denominators, offsets into the tap arrays, the block's
    element count ``4*hq*wq`` and the division magic of ``den_h*den_w``
    (:func:`div_magic`; ``magic`` holds the uint32's bits).
    ``i0h``/``frh`` concatenate every level's phase-major row taps (``2*hq``
    each), ``i0w``/``frw`` the column taps; ``rtap`` packs a row tap as
    ``i0h | frh << 16`` and ``ctap`` (sum of wq, 2) the column taps of
    output column j of both column phases, level by level (level rows
    start at ``tap_w // 2``).

    ``tiles`` (T, len(TILE_COLS)) cut the plane canvas into ``tile_hw``
    rectangles (all four planes), one thread block each, row-major;
    tile t's ``pieces[begin:end]`` (len(PIECE_COLS) columns) are the
    clipped rectangles ``[ya, yb) x [xa, xb)`` of the levels it meets (in
    level order), each with the ``n`` octave columns from
    ``cmin`` its outputs read and, so that the kernel reads one record,
    its level's parameters: ``rtap[rbase + y]`` is canvas row y's row tap
    of row phase 0 (``+ hq``: phase 1), ``ctap[jt + x]`` canvas column x's
    column taps.  A canvas byte in no piece is a gap byte, written 0 by its
    tile's block.  ``oct_hw``
    are the octave shapes, ``plane_hw`` = (PH, PW).
    """

    meta: np.ndarray
    i0h: np.ndarray
    frh: np.ndarray
    i0w: np.ndarray
    frw: np.ndarray
    rtap: np.ndarray
    ctap: np.ndarray
    tiles: np.ndarray
    pieces: np.ndarray
    oct_hw: Tuple[Tuple[int, int], ...]
    plane_hw: Tuple[int, int]
    tile_hw: Tuple[int, int]


def _tile_pieces(meta: np.ndarray, ctap: np.ndarray, plane_hw, tile_hw):
    """``(tiles, pieces)`` of :class:`PlaneTables`, tiles row-major."""
    PH, PW = plane_hw
    TR, TC = tile_hw
    col = {c: i for i, c in enumerate(META_COLS)}
    tiles, pieces = [], []
    for Y0 in range(0, PH, TR):
        for X0 in range(0, PW, TC):
            begin = len(pieces)
            for li, m in enumerate(meta):
                y0, x0 = m[col["y0"]], m[col["x0"]]
                ya, yb = max(Y0, y0), min(Y0 + TR, y0 + m[col["hq"]])
                xa, xb = max(X0, x0), min(X0 + TC, x0 + m[col["wq"]])
                if ya >= yb or xa >= xb:
                    continue
                c = ctap[m[col["tap_w"]] // 2 + xa - x0:
                         m[col["tap_w"]] // 2 + xb - x0] & 0xFFFF
                cmin = int(c.min())
                cmax = min(int(c.max()) + 1, int(m[col["ow"]]) - 1)
                if cmax - cmin + 1 > v_max(TC):
                    raise ValueError(f"level {li}: {cmax - cmin + 1} octave "
                                     f"columns exceed a blend row")
                pieces.append((
                    ya, yb, xa, xb, cmin, cmax - cmin + 1, m[col["oct_off"]],
                    m[col["ow"]], m[col["oh"]], m[col["tap_h"]] - y0,
                    m[col["hq"]], m[col["den_h"]], m[col["den_w"]],
                    m[col["tap_w"]] // 2 - x0, m[col["magic"]],
                    m[col["shift"]]))
            tiles.append((Y0, X0, begin, len(pieces)))
    return (np.asarray(tiles, np.int32).reshape(-1, len(TILE_COLS)),
            np.asarray(pieces, np.int32).reshape(-1, len(PIECE_COLS)))


def plane_tables(packed: PackedPyramidPlan, halo: int,
                 image_hw: Tuple[int, int]) -> PlaneTables:
    """Build the plane kernel's tables for an unpadded ``(Hc, Wc)`` plane
    canvas.  ``halo`` is the even image-space reflect halo baked into the
    taps (``packed.halo`` for reflect-boundary channel functions);
    The tiles are (PLANE_TILE_ROWS, PLANE_TILE_COLS), the kernel's."""
    if halo % 2:
        raise ValueError("the packer guarantees an even baked halo")
    he2 = halo // 2
    PH, PW = packed.canvas_h, packed.canvas_w
    geom = _poly_geom_levels(packed, halo, image_hw)
    n_oct = max((g["oct"] for g in geom), default=-1) + 1
    oct_hw, oct_off, _ = _octave_layout(image_hw, n_oct)
    row0 = _level_rows(packed, he2, PH)
    meta, i0h, frh, i0w, frw = [], [], [], [], []
    tap_h = tap_w = 0
    for li, (pl, g) in enumerate(zip(packed.levels, geom)):
        den = g["den_h"] * g["den_w"]
        if 255 * den >= 2 ** 31:
            raise ValueError(f"level {li}: 255*den_h*den_w overflows int32")
        if max(g["oh"], g["ow"]) >= 1 << 16:
            raise ValueError(f"level {li}: octave side exceeds 16 bits")
        magic, shift = div_magic(den)
        meta.append((oct_off[g["oct"]], g["oh"], g["ow"], g["hq"], g["wq"],
                     row0[li], pl.x - he2, g["den_h"], g["den_w"], tap_h,
                     tap_w, 4 * g["hq"] * g["wq"],
                     np.uint32(magic).view(np.int32), shift))
        i0h.append(g["i0h"])
        frh.append(g["frh"])
        i0w.append(g["i0w"])
        frw.append(g["frw"])
        tap_h += 2 * g["hq"]
        tap_w += 2 * g["wq"]
    cat = lambda parts: np.concatenate(parts).astype(np.int32) if parts \
        else np.zeros(0, np.int32)
    meta = np.asarray(meta, np.int32).reshape(-1, len(META_COLS))
    i0h, frh, i0w, frw = cat(i0h), cat(frh), cat(i0w), cat(frw)
    ctap = np.zeros((tap_w // 2, 2), np.int32)
    for m in meta:
        tw, wq = m[META_COLS.index("tap_w")], m[META_COLS.index("wq")]
        for q in (0, 1):
            sl = slice(tw + q * wq, tw + (q + 1) * wq)
            ctap[tw // 2:tw // 2 + wq, q] = i0w[sl] | (frw[sl] << 16)
    tile_hw = (PLANE_TILE_ROWS, PLANE_TILE_COLS)
    tiles, pieces = _tile_pieces(meta, ctap, (PH, PW), tile_hw)
    return PlaneTables(
        meta=meta, i0h=i0h, frh=frh, i0w=i0w, frw=frw,
        rtap=(i0h | (frh << 16)).astype(np.int32), ctap=ctap, tiles=tiles,
        pieces=pieces, oct_hw=tuple(oct_hw), plane_hw=(PH, PW),
        tile_hw=tile_hw)


@dataclasses.dataclass(frozen=True)
class FloatPlaneTables:
    """Host tables of the float-frame plane builds (``ops/planes.py::
    planes_float`` for exact float frames, ``planes_float_fast`` for fast
    serving mode), one entry per element of the flattened ``(2, 2, PH,
    PW)`` plane canvas.

    ``index`` (4, N) int32: the element's four corners as offsets into the
    flattened octave buffer, in the order (row i0, col i0), (row i0, col
    i1), (row i1, col i0), (row i1, col i1) with ``i1 = min(i0 + 1, n -
    1)``; gap elements point at ``n_src``, one zero appended to the buffer.
    ``fh64``/``fw64`` (N,) float64: the row and column fractions
    (``resize_taps64``; 0 in gaps), ``fh``/``fw`` their f32 roundings.
    ``oct_hw`` are the octave shapes, ``plane_hw`` = (PH, PW)."""

    index: np.ndarray
    fh64: np.ndarray
    fw64: np.ndarray
    fh: np.ndarray
    fw: np.ndarray
    n_src: int
    oct_hw: Tuple[Tuple[int, int], ...]
    plane_hw: Tuple[int, int]


def float_plane_tables(packed: PackedPyramidPlan, halo: int,
                       image_hw: Tuple[int, int]) -> FloatPlaneTables:
    """The tables of every level's float resize into the plane canvas:
    ``resize_taps64`` taps with the (even) reflect ``halo`` baked in and
    phase-major (``_ext_pm_taps``), placed as the uint8 planes are, for an
    unpadded ``(Hc, Wc)`` plane canvas."""
    if halo % 2:
        raise ValueError("the packer guarantees an even baked halo")
    he2 = halo // 2
    PH, PW = packed.canvas_h, packed.canvas_w
    n_oct = max((pl.level.octave for pl in packed.levels), default=-1) + 1
    oct_hw, oct_off, n_src = _octave_layout(image_hw, n_oct)
    if n_src >= 2 ** 31:
        raise ValueError("octave buffer exceeds int32 offsets")
    row0 = _level_rows(packed, he2, PH)
    N = 4 * PH * PW
    index = np.full((4, N), n_src, np.int32)
    fh = np.zeros(N, np.float64)
    fw = np.zeros(N, np.float64)
    for li, pl in enumerate(packed.levels):
        lv = pl.level
        oh, ow = oct_hw[lv.octave]
        i0h, frh = (_ext_pm_taps(t, lv.height, halo)
                    for t in resize_taps64(oh, lv.height))
        i0w, frw = (_ext_pm_taps(t, lv.width, halo)
                    for t in resize_taps64(ow, lv.width))
        hq, wq = len(i0h) // 2, len(i0w) // 2
        rows = [i0h.astype(np.int64), np.minimum(i0h + 1, oh - 1)]
        cols = [i0w.astype(np.int64), np.minimum(i0w + 1, ow - 1)]
        # (p, q, r, c) of the level block -> flat canvas element
        p, q, r, c = np.meshgrid(np.arange(2), np.arange(2), np.arange(hq),
                                 np.arange(wq), indexing="ij")
        y0, x0 = row0[li], pl.x - he2
        pos = ((p * 2 + q) * PH + y0 + r) * PW + x0 + c
        hr, wc = p * hq + r, q * wq + c
        for k in range(4):
            index[k, pos] = oct_off[lv.octave] + rows[k >> 1][hr] * ow \
                + cols[k & 1][wc]
        fh[pos] = frh[hr]
        fw[pos] = frw[wc]
    return FloatPlaneTables(index=index, fh64=fh, fw64=fw,
                            fh=fh.astype(np.float32), fw=fw.astype(np.float32),
                            n_src=n_src, oct_hw=tuple(oct_hw),
                            plane_hw=(PH, PW))
