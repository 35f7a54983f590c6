"""Runtime cascade tables and kernel B6: the generic cascade over every
window origin.

Counterpart of ``waldboost_tpu/ops/cascade.py`` (``Cascade``,
``CascadeMeta``, ``cascade_from_stages``, ``cascade_response_grid``,
``cascade_survivor_counts``, ``cascade_predict_samples``) and of the
Pallas kernel ``waldboost_tpu/ops/cascade_pallas.py::
cascade_response_grid_pallas``.  The tables are built exactly as JAX builds
them: nodes reordered internal-first, or canonicalized into complete heap
trees when every tree is at most ``MAX_COMPLETE_DEPTH`` deep, and padded to
``n_stages`` with inert stages (``active`` false, prediction 0, theta
-inf).

:func:`cascade_response_grid` takes a CPU tensor to the plain lockstep
version (:func:`cascade_response_grid_plain`, the counterpart of the XLA
function) and a CUDA tensor to kernel B6 (``csrc/cascade.cu``,
``wb_cascade_response``, over :func:`node_records`).  Per window origin
set in the valid mask and per
stage in order: ``n_weak`` counts the stage if it is active, the tree
walk adds the leaf to ``hs`` in f32 from 0, and the window dies when
``hs >= theta`` fails.  A dead window keeps the ``hs`` of the stage it died
in; an origin outside the mask keeps 0.

:func:`cascade_suffix_sparse` (two-phase serving's suffix, the
counterpart of JAX's XLA function of that name) walks stages ``[start,
T)`` over a list of window origins from their prefix scores: kernel S1
(``csrc/cascade.cu``, ``wb_cascade_suffix``) on a CUDA tensor,
:func:`cascade_suffix_sparse_plain` on a CPU tensor; both read the
tables of :func:`node_records`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import entry, launch, on_card
from ..device import resolve_device

__all__ = ["Cascade", "CascadeMeta", "NEG_INF", "MAX_COMPLETE_DEPTH",
           "NODE_KEYS", "check_children", "tree_depth", "stage_tables",
           "GENERAL", "HEAP2", "NodeRecords", "node_records",
           "FRONT_REJECTS", "FRONT_FOOTPRINT_BYTES",
           "FRONT_NONE", "FRONT_STAGED", "FRONT_GLOBAL", "front_stages",
           "front_footprint", "FrontRecords", "front_records",
           "stack_node_table", "cascade_from_stages", "lockstep",
           "cascade_response_grid", "cascade_response_grid_plain",
           "cascade_survivor_counts", "cascade_predict_samples",
           "cascade_stage_responses",
           "slice_cascade", "cascade_suffix_sparse",
           "cascade_suffix_sparse_plain"]

NEG_INF = np.float32(-np.inf)

#: canonicalize to complete heap trees when the cascade depth is at most
#: this (2^(D+1)-1 nodes; beyond it the general node tables are kept)
MAX_COMPLETE_DEPTH = 4

NODE_KEYS = ("fr", "fc", "fch", "thr", "left", "right", "pred")


class CascadeMeta(NamedTuple):
    depth: int       # max routing steps of any stage tree
    n_internal: int  # max count of internal nodes per stage
    complete: bool = False  # node tables are canonical complete heap trees


@dataclasses.dataclass(frozen=True)
class Cascade:
    """(T, NN) node tables, (T,) ``theta`` and ``active``, torch tensors on
    one device.  Checked when built: every internal node's children lie
    above it and inside the table, so a tree walk always ends."""

    fr: torch.Tensor    # int32 feature row offset within the window
    fc: torch.Tensor    # int32 feature column offset
    fch: torch.Tensor   # int32 feature channel
    thr: torch.Tensor   # float32 split threshold
    left: torch.Tensor  # int32 left child (-1 at a leaf)
    right: torch.Tensor  # int32 right child
    pred: torch.Tensor  # float32 node prediction
    theta: torch.Tensor  # float32 rejection threshold (-inf: none)
    active: torch.Tensor  # bool, False for inert padding stages

    def __post_init__(self):
        h = self.host
        T = h["fr"].shape[0]
        inner = check_children(h["left"], h["right"])
        if np.any(inner & ((h["fr"] < 0) | (h["fc"] < 0) | (h["fch"] < 0))):
            raise ValueError("cascade feature offsets must be >= 0")
        if h["theta"].shape != (T,) or h["active"].shape != (T,):
            raise ValueError("theta and active need one entry per stage")

    @functools.cached_property
    def host(self) -> dict:
        """numpy copies of the tables (copied from the device once)."""
        return {k: getattr(self, k).cpu().numpy()
                for k in NODE_KEYS + ("theta", "active")}

    @functools.cached_property
    def feature_extent(self) -> Tuple[int, int, int]:
        """1 + the largest (row, col, channel) an internal node reads."""
        h = self.host
        inner = h["left"] >= 0
        return tuple(int(h[k][inner].max()) + 1 if inner.any() else 0
                     for k in ("fr", "fc", "fch"))

    @functools.cached_property
    def _records(self) -> dict:
        return {}

    def records(self, shape: Tuple[int, int, int]) -> "NodeRecords":
        """The :func:`node_records` of these tables for a (C, H, W) canvas,
        on the tables' device (built once per shape)."""
        if shape not in self._records:
            h = self.host
            self._records[shape] = NodeRecords.build(
                h, h["theta"], h["active"], shape, self.device)
        return self._records[shape]

    @property
    def n_stages(self) -> int:
        return self.fr.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.fr.shape[1]

    @property
    def device(self) -> torch.device:
        return self.fr.device

    def to(self, device) -> "Cascade":
        return Cascade(*(getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)))


def check_children(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Raise unless every internal node of the (T, NN) tables has its
    children above it and inside the table, so a tree walk always ends;
    returns the mask of internal nodes."""
    nn = left.shape[1]
    inner = left >= 0
    node = np.arange(nn)[None, :]
    for child in (left, right):
        if np.any(inner & ((child <= node) | (child >= nn))):
            raise ValueError("cascade tree: a child index must lie above "
                             "its parent and inside the table")
    return inner


def tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Longest root->leaf path (routing steps) of a flat-array tree."""
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    if left.size == 0:
        return 0

    def depth(n: int) -> int:
        if left[n] < 0:
            return 0
        return 1 + max(depth(int(left[n])), depth(int(right[n])))

    return depth(0)


def _tree_to_complete(feature, thr, left, right, pred, D):
    """A flat tree of depth <= D as a complete heap-ordered depth-D tree
    with the same responses: a shallow leaf becomes a pass-through split
    (feature (0, 0, 0), threshold 0) whose children repeat its
    prediction."""
    nn = 2 ** (D + 1) - 1
    cfeat = np.zeros((nn, 3), np.int32)
    cthr = np.zeros(nn, np.float32)
    cleft = np.full(nn, -1, np.int32)
    cright = np.full(nn, -1, np.int32)
    cpred = np.zeros(nn, np.float32)

    def rec(orig, heap, d):
        cpred[heap] = pred[orig]
        if d == D:
            return
        cleft[heap] = 2 * heap + 1
        cright[heap] = 2 * heap + 2
        if left[orig] < 0:
            rec(orig, 2 * heap + 1, d + 1)
            rec(orig, 2 * heap + 2, d + 1)
        else:
            cfeat[heap] = feature[orig]
            cthr[heap] = thr[orig]
            rec(int(left[orig]), 2 * heap + 1, d + 1)
            rec(int(right[orig]), 2 * heap + 2, d + 1)

    rec(0, 0, 0)
    return cfeat, cthr, cleft, cright, cpred


def _empty_tables(T: int, nn: int) -> dict:
    return {"fr": np.zeros((T, nn), np.int32),
            "fc": np.zeros((T, nn), np.int32),
            "fch": np.zeros((T, nn), np.int32),
            "thr": np.zeros((T, nn), np.float32),
            "left": np.full((T, nn), -1, np.int32),
            "right": np.full((T, nn), -1, np.int32),
            "pred": np.zeros((T, nn), np.float32)}


def _stage_arrays(s: dict):
    k = len(s["threshold"])
    return (np.maximum(np.asarray(s["feature"], np.int32).reshape(k, 3), 0),
            np.asarray(s["threshold"], np.float32),
            np.asarray(s["left"], np.int32), np.asarray(s["right"], np.int32),
            np.asarray(s["prediction"], np.float32))


def _put(out: dict, t: int, ftr, thr, left, right, pred) -> None:
    """Write one stage's k nodes into row t of the tables."""
    k = len(thr)
    out["fr"][t, :k], out["fc"][t, :k], out["fch"][t, :k] = np.asarray(ftr).T
    out["thr"][t, :k] = thr
    out["left"][t, :k] = left
    out["right"][t, :k] = right
    out["pred"][t, :k] = pred


def stage_tables(stages: Sequence[dict]) -> dict:
    """Unpadded (T, NN) tables of stage dicts in their own node order."""
    out = _empty_tables(len(stages), max((len(s["threshold"])
                                          for s in stages), default=1))
    for t, s in enumerate(stages):
        _put(out, t, *_stage_arrays(s))
    return out


def stack_node_table(stages: Sequence[dict], n_nodes: Optional[int] = None
                     ) -> Tuple[dict, CascadeMeta]:
    """Stage dicts (``feature`` (k, 3), ``threshold``, ``left``, ``right``,
    ``prediction``) stacked into (T, NN) numpy tables.

    With every tree at most ``MAX_COMPLETE_DEPTH`` deep (and ``n_nodes``
    not given) the stages become complete heap trees of the cascade's
    depth; otherwise each stage's nodes are reordered internal-first
    (stable) and padded with inert leaves."""
    T = len(stages)
    max_depth = max((tree_depth(s["left"], s["right"]) for s in stages),
                    default=0)
    if T and 0 < max_depth <= MAX_COMPLETE_DEPTH and n_nodes is None:
        return _stack_complete(stages, max_depth)
    if n_nodes is None:
        n_nodes = max((len(s["threshold"]) for s in stages), default=1)
    out = _empty_tables(T, max(int(n_nodes), 1))
    max_depth, n_internal = 0, 1
    for t, s in enumerate(stages):
        ftr, thr, left, right, pred = _stage_arrays(s)
        k = len(thr)
        is_leaf = left < 0
        perm = np.argsort(is_leaf, kind="stable")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(k)
        remap = lambda c: np.where(c >= 0, inv[np.maximum(c, 0)], -1)
        _put(out, t, ftr[perm], thr[perm], remap(left[perm]),
             remap(right[perm]), pred[perm])
        n_internal = max(n_internal, int((~is_leaf).sum()))
        max_depth = max(max_depth, tree_depth(out["left"][t],
                                              out["right"][t]))
    return out, CascadeMeta(depth=max_depth, n_internal=n_internal,
                            complete=False)


def _stack_complete(stages: Sequence[dict], D: int) -> Tuple[dict, CascadeMeta]:
    out = _empty_tables(len(stages), 2 ** (D + 1) - 1)
    for t, s in enumerate(stages):
        _put(out, t, *_tree_to_complete(*_stage_arrays(s), D))
    return out, CascadeMeta(depth=D, n_internal=2 ** D - 1, complete=True)


def cascade_from_stages(stages: Sequence[dict], thetas: Sequence[float],
                        n_nodes: Optional[int] = None,
                        n_stages: Optional[int] = None, device=None
                        ) -> Tuple[Cascade, CascadeMeta]:
    """The :class:`Cascade` of stage dicts and thetas on ``device`` (the
    card when None), padded to ``n_stages`` stages (padding stages are
    inactive, predict 0 and have theta -inf)."""
    T = len(stages)
    pad_T = int(n_stages) if n_stages is not None else T
    arrays, meta = stack_node_table(list(stages), n_nodes=n_nodes)
    theta = np.full(pad_T, NEG_INF, np.float32)
    if T:
        theta[:T] = np.asarray(list(thetas), np.float32)
    active = np.zeros(pad_T, bool)
    active[:T] = True
    pad = _empty_tables(pad_T - T, arrays["fr"].shape[1])
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    casc = Cascade(*(t(np.concatenate([arrays[k], pad[k]]))
                     for k in NODE_KEYS), theta=t(theta), active=t(active))
    return casc, meta


# ---------------------------------------------------------------------------
# packed node records (the tables as csrc/cascade.cu reads them)
# ---------------------------------------------------------------------------

#: record layouts of csrc/cascade.cu: general node records, or one record
#: per stage of a complete depth-2 heap
GENERAL, HEAP2 = 0, 1
#: most nodes per stage a record's two 16-bit child fields can address
MAX_RECORD_NODES = 1 << 15


def _offsets(tab: dict, shape: Tuple[int, int, int]) -> np.ndarray:
    C, H, W = shape
    if C * H * W >= 2 ** 31:
        raise ValueError("cascade: canvas offsets must fit in int32")
    off = (tab["fch"].astype(np.int64) * H + tab["fr"]) * W + tab["fc"]
    if off.size and (off.min() < 0 or off.max() >= 2 ** 31):
        raise ValueError("cascade: a feature offset outside int32")
    return off


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _heap2(tab: dict) -> Optional[dict]:
    """The (T, 7) tables as complete depth-2 heaps (node n's children 2n+1,
    2n+2; shallow leaves become pass-through splits, the same responses),
    or None when a tree is deeper than 2."""
    T = tab["fr"].shape[0]
    if any(tree_depth(tab["left"][t], tab["right"][t]) > 2 for t in range(T)):
        return None
    out = _empty_tables(T, 7)
    for t in range(T):
        ftr = np.stack([tab["fr"][t], tab["fc"][t], tab["fch"][t]], axis=1)
        _put(out, t, *_tree_to_complete(ftr, tab["thr"][t], tab["left"][t],
                                        tab["right"][t], tab["pred"][t], 2))
    return out


def node_records(tab: dict, theta, counts, shape: Tuple[int, int, int]
                 ) -> Tuple[int, np.ndarray]:
    """``(layout, records)``: the (T, NN) node tables ``tab`` (numpy, keys
    of ``NODE_KEYS``) packed for a (C, H, W) canvas as one int32 array, with
    per stage its theta and ``counts`` (1 if the stage counts toward
    n_weak).  Feature positions become canvas offsets ``fch*H*W + fr*W +
    fc``; float32 values are stored as their bits.

    * ``HEAP2`` when every tree is at most 2 deep: per stage, as the
      complete depth-2 heap, 48 bytes ``(off0, thr0, off1, thr1, off2,
      thr2, theta, counts, pred3, pred4, pred5, pred6)``.
    * ``GENERAL`` otherwise: per stage the pair ``(theta, counts)``, padded
      to an even number of stages, then per stage and node the 16-byte
      record ``(off, thr, left | right << 16 or -1 at a leaf, pred)``."""
    T, NN = tab["fr"].shape
    heap = _heap2(tab) if T else None
    if heap is not None:
        off = _offsets(heap, shape)
        rec = np.zeros((T, 12), np.int32)
        rec[:, 0:6:2] = off[:, :3]
        rec[:, 1:6:2] = _bits(heap["thr"][:, :3])
        rec[:, 6] = _bits(theta)
        rec[:, 7] = np.asarray(counts, bool)
        rec[:, 8:] = _bits(heap["pred"][:, 3:])
        return HEAP2, rec.ravel()
    if NN > MAX_RECORD_NODES:
        raise ValueError(f"cascade: {NN} nodes per stage, at most "
                         f"{MAX_RECORD_NODES} are supported")
    off = _offsets(tab, shape)
    left, right = tab["left"], tab["right"]
    kids = np.where(left >= 0, (left & 0xFFFF) | (right.astype(np.int64) << 16),
                    -1)
    rec = np.stack([off, _bits(tab["thr"]), kids, _bits(tab["pred"])],
                   axis=-1).astype(np.int32)
    stage = np.zeros((T + T % 2, 2), np.int32)
    stage[:T, 0] = _bits(theta)
    stage[:T, 1] = np.asarray(counts, bool)
    return GENERAL, np.concatenate([stage.ravel(), rec.ravel()])


#: kernel B3f's dense front (csrc/cascade_fast.cu): the stages with finite
#: theta it runs through (0: no front) and the most bytes of one staged
#: footprint (beyond it the front reads the canvas from global memory).
#: The tile of origins is the kernel's own (``wb_cascade_fast_tile``).
FRONT_REJECTS = 2
FRONT_FOOTPRINT_BYTES = 64 * 1024
#: where the front reads the canvas: no front, a staged footprint, global
#: memory
FRONT_NONE, FRONT_STAGED, FRONT_GLOBAL = 0, 1, 2


def front_stages(theta, n_rejects: int) -> int:
    """How many stages the front runs: stages 0 .. F-1, through the
    ``n_rejects``-th stage whose theta is finite (all of them when the
    cascade has fewer such stages; 0 when ``n_rejects`` is 0)."""
    if n_rejects <= 0:
        return 0
    finite = np.flatnonzero(np.isfinite(np.asarray(theta, np.float32)))
    return int(finite[n_rejects - 1]) + 1 if len(finite) >= n_rejects \
        else len(theta)


def front_footprint(window: Tuple[int, int], tile: Tuple[int, int]
                    ) -> Tuple[int, int]:
    """``(FH, FW)``: the canvas rows a tile's windows read and the staged
    row pitch in elements (the columns they read, rounded up to 8 bfloat16
    values: 16 bytes)."""
    (m, n), (tr, tc) = window, tile
    return tr + m - 1, -(-(tc + n - 1) // 8) * 8


class FrontRecords(NamedTuple):
    """The records of B3f's dense front for one canvas shape, window and
    tile: ``mode`` (``FRONT_NONE``, ``FRONT_STAGED``, ``FRONT_GLOBAL``),
    ``n_stages`` (F), the footprint ``fh`` x ``fw``, the tile, and
    ``data``: F stages of HEAP2 records (:func:`node_records`) whose feature
    offsets are in the staged footprint's strides ``fch*FH*FW + fr*FW +
    fc`` (``FRONT_STAGED``) or the canvas's (``FRONT_GLOBAL``)."""
    mode: int
    n_stages: int
    fh: int
    fw: int
    tile: Tuple[int, int]
    data: np.ndarray


def front_records(tab: dict, theta, counts, shape: Tuple[int, int, int],
                  window: Tuple[int, int], tile: Tuple[int, int],
                  stageable: bool = True) -> FrontRecords:
    """The dense front of the (T, NN) tables ``tab`` over a (C, H, W)
    bfloat16 canvas, for the kernel's ``tile`` of origins: stages 0 ..
    F-1 (:func:`front_stages` of ``FRONT_REJECTS``) as HEAP2 records in
    the strides of a tile's staged footprint when the canvas can be staged
    (``stageable``: its rows and base on 16 bytes) and two bytes an
    element fit ``FRONT_FOOTPRINT_BYTES``, else in the canvas's.  No front
    (F 0) when those stages hold a tree deeper than 2."""
    tile = tuple(tile)
    C = shape[0]
    fh, fw = front_footprint(window, tile)
    F = front_stages(theta, FRONT_REJECTS)
    none = FrontRecords(FRONT_NONE, 0, fh, fw, tile, np.zeros(4, np.int32))
    if F == 0:
        return none
    sub = {k: np.asarray(v)[:F] for k, v in tab.items()}
    staged = stageable and 2 * C * fh * fw <= FRONT_FOOTPRINT_BYTES
    layout, rec = node_records(sub, np.asarray(theta)[:F],
                               np.asarray(counts)[:F],
                               (C, fh, fw) if staged else tuple(shape))
    if layout != HEAP2:
        return none
    return FrontRecords(FRONT_STAGED if staged else FRONT_GLOBAL, F, fh, fw,
                        tile, rec)


class NodeRecords(NamedTuple):
    """:func:`node_records` on a device."""
    layout: int
    data: torch.Tensor

    @staticmethod
    def build(tab: dict, theta, counts, shape, device) -> "NodeRecords":
        layout, rec = node_records(tab, theta, counts, shape)
        return NodeRecords(layout, torch.as_tensor(rec, device=device))


# ---------------------------------------------------------------------------
# plain lockstep evaluation (shared by the plain versions of B3, B4, B6)
# ---------------------------------------------------------------------------

def _stage_response(canvas: torch.Tensor, tab: dict, t: int, gu: int,
                    gv: int) -> torch.Tensor:
    """Stage t's tree response at every window origin of a (B, C, H, W)
    canvas: the tree walked as a select tree over shifted canvas slices."""
    fr, fc, fch, thr, left, right, pred = (tab[k][t] for k in NODE_KEYS)

    def resp(node):
        if left[node] < 0:
            return torch.tensor(float(pred[node]), dtype=torch.float32,
                                device=canvas.device)
        r, c, ch = int(fr[node]), int(fc[node]), int(fch[node])
        go_left = canvas[:, ch, r:r + gu, c:c + gv] <= float(thr[node])
        return torch.where(go_left, resp(int(left[node])),
                           resp(int(right[node])))

    return resp(0)


def cascade_stage_responses(chns: torch.Tensor, casc: Cascade,
                            window: Tuple[int, int], meta) -> torch.Tensor:
    """Per-stage weak responses of every window origin of a (C, U, V)
    channel tensor: (T, GU, GV) float32 with ``(GU, GV) = (U - m, V - n)``,
    each stage's tree walked at every origin regardless of rejection (a
    stage's response depends only on the channels), for offline threshold
    calibration; padding stages give 0.  Plain torch on the tables'
    device.  ``meta`` (a :class:`CascadeMeta` or a depth) is JAX's; the
    walk follows each tree's own children, complete heaps and general
    tables alike."""
    C, U, V = chns.shape
    m, n = window
    gu, gv = max(U - m, 0), max(V - n, 0)
    canvas = chns.to(casc.device, torch.float32)[None]
    tab = casc.host
    return torch.stack([
        _stage_response(canvas, tab, t, gu, gv).expand(1, gu, gv)[0]
        for t in range(casc.n_stages)]) if casc.n_stages else \
        torch.zeros((0, gu, gv), dtype=torch.float32, device=casc.device)


def lockstep(canvas: torch.Tensor, valid: torch.Tensor, tab: dict,
             theta: Sequence[float], n_stages: int,
             active: Optional[Sequence[bool]] = None):
    """Every stage over every window origin in lockstep (plain torch).

    ``canvas`` (B, C, H, W) float32, ``valid`` (GU, GV) initial alive mask,
    ``tab`` numpy node tables (keys fr, fc, fch, thr, left, right, pred),
    ``theta`` per-stage floats (-inf: no rejection), ``active`` per-stage
    flags of the stages ``n_weak`` counts (all when None).  Returns ``(hs,
    alive, n_weak, entering)``: (B, GU, GV) float32 and bool, (B,) int32,
    and the (n_stages, B) int64 windows alive entering each stage.  Dead
    windows add 0, so ``hs`` keeps the value of the stage a window died
    in; every window sees the kernels' sequence of f32 adds."""
    B = canvas.shape[0]
    gu, gv = valid.shape
    dev = canvas.device
    alive = valid.bool().unsqueeze(0).expand(B, gu, gv).clone()
    hs = torch.zeros((B, gu, gv), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_weak = torch.zeros(B, dtype=torch.int64, device=dev)
    entering = []
    for t in range(n_stages):
        cnt = alive.sum(dim=(1, 2))
        entering.append(cnt)
        if active is None or active[t]:
            n_weak += cnt
        hs = hs + torch.where(alive, _stage_response(canvas, tab, t, gu, gv),
                              zero)
        alive &= hs >= float(theta[t])
    entering = torch.stack(entering) if entering else \
        torch.zeros((0, B), dtype=torch.int64, device=dev)
    return hs, alive, n_weak.to(torch.int32), entering


# ---------------------------------------------------------------------------
# the walk's launch (B3, B4, B6) and kernel B6
# ---------------------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int
#: canvas, its element bytes, B, C, H, W, valid, gu, gv, records, bytes,
#: layout, T, n_run, NN, 3 outputs, stream
_WALK_ARGS = (_VP, _CI, _CI, _CI, _CI, _CI, _VP, _CI, _CI, _VP, _CI, _CI,
              _CI, _CI, _CI, _VP, _VP, _VP, _VP)
#: the C entry of csrc/cascade.cu each kernel of the walk launches
_WALK_ENTRY = {"cascade": "wb_cascade",
               "cascade_response": "wb_cascade_response",
               "cascade_generic": "wb_cascade_response"}


def launch_response(kernel: str, canvas: torch.Tensor, valid: torch.Tensor,
                    records: NodeRecords, n_stages: int, n_run: int,
                    n_nodes: int, out0, out1, n_weak) -> None:
    """Launch the walk of ``csrc/cascade.cu`` on the current stream over
    the packed ``records`` of ``n_stages`` stages of ``n_nodes`` nodes,
    walking the first ``n_run``, as ``kernel``: ``"cascade"`` (B3,
    ``wb_cascade``: outputs masked, count, n_weak; a float32 canvas) or
    ``"cascade_response"`` (B4) or ``"cascade_generic"`` (B6), both
    ``wb_cascade_response`` (outputs hs, alive, n_weak; the canvas float32
    or bfloat16)."""
    B, C, H, W = canvas.shape
    gu, gv = valid.shape
    launch(kernel, entry("cascade", _WALK_ENTRY[kernel], _WALK_ARGS),
           canvas.device, canvas.data_ptr(), canvas.element_size(), B, C, H,
           W, valid.data_ptr(), gu, gv, records.data.data_ptr(),
           records.data.numel() * 4, records.layout, n_stages, n_run,
           n_nodes, out0.data_ptr(), out1.data_ptr(), n_weak.data_ptr())


def _grid_args(canvas: torch.Tensor, casc: Cascade, window, valid):
    """Checks, and the batched canvas and uint8 mask of a B6 call."""
    if canvas.dtype != torch.float32 or canvas.dim() not in (3, 4):
        raise ValueError("cascade: canvas must be (C, H, W) or (B, C, H, W) "
                         "float32")
    batched = canvas.dim() == 4
    cv = canvas if batched else canvas.unsqueeze(0)
    if not cv.is_contiguous():
        raise ValueError("cascade: canvas must be contiguous")
    m, n = window
    B, C, H, W = cv.shape
    gu, gv = max(H - m, 0), max(W - n, 0)
    er, ec, ech = casc.feature_extent
    if er > m or ec > n or ech > C:
        raise ValueError("cascade feature outside the window")
    if valid is None:
        valid = torch.ones((gu, gv), dtype=torch.uint8, device=cv.device)
    if tuple(valid.shape) != (gu, gv) or valid.dtype not in (torch.uint8,
                                                            torch.bool):
        raise ValueError(f"cascade: valid mask must be a ({gu}, {gv}) uint8 "
                         "or bool tensor")
    valid = valid.to(torch.uint8).contiguous()
    if not cv.device == valid.device == casc.device:
        raise ValueError("cascade: canvas, mask and tables on different "
                         "devices")
    return batched, cv, valid


def _unbatch(batched, hs, alive, n_weak):
    return (hs, alive, n_weak) if batched else (hs[0], alive[0], n_weak[0])


def cascade_response_grid(canvas: torch.Tensor, casc: Cascade,
                          window: Tuple[int, int],
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hs, alive, n_weak)`` of the cascade at every window origin of a
    (C, H, W) canvas or a (B, C, H, W) batch: float32 and bool maps on the
    (H - m, W - n) grid and int32 ``n_weak`` (per image for a batch).
    ``valid`` pre-kills origins (all alive when None)."""
    batched, cv, valid = _grid_args(canvas, casc, window, valid)
    if not on_card(cv, "cascade"):
        return _unbatch(batched, *_plain(cv, casc, valid))
    B = cv.shape[0]
    gu, gv = valid.shape
    hs = torch.empty((B, gu, gv), dtype=torch.float32, device=cv.device)
    alive = torch.empty((B, gu, gv), dtype=torch.bool, device=cv.device)
    n_weak = torch.zeros(B, dtype=torch.int32, device=cv.device)
    if B and gu and gv:
        launch_response("cascade_generic", cv, valid,
                        casc.records(tuple(cv.shape[1:])), casc.n_stages,
                        casc.n_stages, casc.n_nodes, hs, alive, n_weak)
    return _unbatch(batched, hs, alive, n_weak)


def _plain(cv, casc, valid):
    h = casc.host
    hs, alive, n_weak, _ = lockstep(cv, valid, h, h["theta"].tolist(),
                                    casc.n_stages, h["active"].tolist())
    return hs, alive, n_weak


def cascade_response_grid_plain(canvas: torch.Tensor, casc: Cascade,
                                window: Tuple[int, int],
                                valid: Optional[torch.Tensor] = None):
    """Plain-torch version of :func:`cascade_response_grid` (kernel B6)."""
    batched, cv, valid = _grid_args(canvas, casc, window, valid)
    return _unbatch(batched, *_plain(cv, casc, valid))


# ---------------------------------------------------------------------------
# two-phase serving's suffix: kernel S1
# ---------------------------------------------------------------------------

def slice_cascade(casc: Cascade, start: int, stop: int) -> Cascade:
    """Stages ``[start, stop)`` of a cascade (views of its tables)."""
    return Cascade(*(getattr(casc, f.name)[start:stop]
                     for f in dataclasses.fields(casc)))


def _suffix_tables(casc, shape):
    """``(tab, theta, counts, records)`` of a :class:`Cascade` (stages
    counted where ``active``) or of a ``cascade_static.CascadeOperands``
    (every stage counted, theta -inf where not finite) for a (C, H, W)
    canvas."""
    if isinstance(casc, Cascade):
        h = casc.host
        return h, h["theta"], h["active"], casc.records(shape)
    return (vars(casc.sc), casc.theta, np.ones(casc.sc.n_stages, bool),
            casc.records(shape))


def _suffix_args(chns, casc, window, idx, scores, alive, start, content_hw):
    if chns.dtype not in (torch.float32, torch.bfloat16) \
            or chns.dim() not in (3, 4):
        raise ValueError("cascade_suffix_sparse: canvas must be (C, H, W) "
                         "or (B, C, H, W) float32 or bfloat16")
    batched = chns.dim() == 4
    cv = chns if batched else chns.unsqueeze(0)
    if not cv.is_contiguous():
        raise ValueError("cascade_suffix_sparse: canvas must be contiguous")
    lists = [x if batched else x.unsqueeze(0) for x in (idx, scores, alive)]
    B = cv.shape[0]
    S = lists[0].shape[-1]
    if any(tuple(x.shape) != (B, S) for x in lists):
        raise ValueError(f"cascade_suffix_sparse: idx, scores and alive must "
                         f"be ({B}, S) lists")
    if any(x.device != cv.device for x in lists):
        raise ValueError("cascade_suffix_sparse: canvas and lists on "
                         "different devices")
    if int(start) < 0:
        raise ValueError(f"start must be >= 0, got {start}")
    m, n = window
    gv = (content_hw[1] if content_hw is not None else cv.shape[3]) - n
    if gv <= 0:
        raise ValueError("cascade_suffix_sparse: the window is wider than "
                         "the canvas")
    idx, scores, alive = (lists[0].to(torch.int64).contiguous(),
                          lists[1].to(torch.float32).contiguous(),
                          lists[2].to(torch.bool).contiguous())
    return batched, cv, idx, scores, alive, gv


def _unbatch_list(batched, H, alive, n_weak):
    return (H, alive, n_weak) if batched else (H[0], alive[0], n_weak[0])


def cascade_suffix_sparse(chns: torch.Tensor, casc, window: Tuple[int, int],
                          meta, idx: torch.Tensor, scores: torch.Tensor,
                          alive: torch.Tensor, start: int,
                          content_hw: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stages ``[start, T)`` of ``casc`` over a list of window origins.

    ``chns`` is a (C, H, W) canvas or a (B, C, H, W) batch, float32 or
    bfloat16 (each value widened to f32 at its read); ``idx`` (S,) or
    (B, S) flat origin indices ``r * gv + c`` into the window grid, whose
    width ``gv`` is ``W - n`` (``content_hw[1] - n`` when given: the
    canvas is then an allocation whose top-left block is the content);
    ``scores`` the entries' scores after the first ``start`` stages and
    ``alive`` their flags.  ``casc`` is a :class:`Cascade` (n_weak counts
    the stages whose ``active`` flag is set) or a frozen cascade's
    ``CascadeOperands`` (every stage counts).  ``meta`` is JAX's
    :class:`CascadeMeta`; the records carry the tree layout, so it is not
    read.

    Returns ``(H, alive, n_weak)``: each entry's score after stage T - 1
    (a rejected entry keeps the score of the stage it died in, a dead one
    its input score), its flag, and the int32 count of stages entries
    entered alive (per image for a batch).  Kernel S1 on a CUDA tensor,
    :func:`cascade_suffix_sparse_plain` on a CPU tensor."""
    batched, cv, idx, scores, alive, gv = _suffix_args(
        chns, casc, window, idx, scores, alive, start, content_hw)
    if not on_card(cv, "cascade"):
        return _unbatch_list(batched, *_suffix_plain(cv, casc, idx, scores,
                                                     alive, start, gv))
    _, _, _, rec = _suffix_tables(casc, tuple(cv.shape[1:]))
    if rec.data.device != cv.device:
        raise ValueError("cascade_suffix_sparse: canvas and tables on "
                         "different devices")
    B, C, H, W = cv.shape
    S = idx.shape[1]
    T, NN = _n_stages_nodes(casc)
    h_out = torch.empty((B, S), dtype=torch.float32, device=cv.device)
    a_out = torch.empty((B, S), dtype=torch.bool, device=cv.device)
    n_weak = torch.zeros(B, dtype=torch.int32, device=cv.device)
    launch("cascade_suffix",
           entry("cascade", "wb_cascade_suffix", _SUFFIX_ARGS), cv.device,
           cv.data_ptr(), cv.element_size(), B, C, H, W, gv, idx.data_ptr(),
           scores.data_ptr(), alive.data_ptr(), S, rec.data.data_ptr(),
           rec.layout, T, int(start), NN, h_out.data_ptr(), a_out.data_ptr(),
           n_weak.data_ptr())
    return _unbatch_list(batched, h_out, a_out, n_weak)


#: canvas, element bytes, B, C, H, W, gv, idx, h_in, alive_in, S, records,
#: layout, T, start, NN, h_out, alive_out, n_weak, stream
_SUFFIX_ARGS = (_VP,) + (_CI,) * 6 + (_VP,) * 3 + (_CI, _VP) + (_CI,) * 4 + \
    (_VP,) * 4


def _n_stages_nodes(casc) -> Tuple[int, int]:
    sc = casc if isinstance(casc, Cascade) else casc.sc
    return int(sc.fr.shape[0]), int(sc.fr.shape[1])


def cascade_suffix_sparse_plain(chns: torch.Tensor, casc,
                                window: Tuple[int, int], meta,
                                idx: torch.Tensor, scores: torch.Tensor,
                                alive: torch.Tensor, start: int,
                                content_hw: Optional[Tuple[int, int]] = None):
    """Plain-torch version of :func:`cascade_suffix_sparse` (kernel S1)."""
    batched, cv, idx, scores, alive, gv = _suffix_args(
        chns, casc, window, idx, scores, alive, start, content_hw)
    return _unbatch_list(batched, *_suffix_plain(cv, casc, idx, scores,
                                                 alive, start, gv))


def _suffix_plain(cv, casc, idx, scores, alive, start, gv):
    """Every entry through stages [start, T) in lockstep: per stage the
    tree routed its depth in steps (a leaf routes to itself) over gathered
    canvas values, then JAX's adds and compares."""
    B, C, H, W = cv.shape
    tab, theta, counts, _ = _suffix_tables(casc, (C, H, W))
    flat = cv.reshape(B, -1).float()
    base = torch.div(idx, gv, rounding_mode="floor") * W + idx % gv
    off = torch.as_tensor((tab["fch"].astype(np.int64) * H + tab["fr"]) * W
                          + tab["fc"], device=cv.device)
    t_ = lambda k: torch.as_tensor(tab[k], device=cv.device)
    thr, pred = t_("thr"), t_("pred")
    left, right = t_("left").long(), t_("right").long()
    Hs, alive = scores.clone(), alive.clone()
    n_weak = torch.zeros(B, dtype=torch.int64, device=cv.device)
    zero = torch.zeros((), dtype=torch.float32, device=cv.device)
    for t in range(int(start), len(theta)):
        node = torch.zeros_like(idx)
        for _ in range(tree_depth(tab["left"][t], tab["right"][t])):
            v = torch.gather(flat, 1, base + off[t][node])
            nxt = torch.where(v <= thr[t][node], left[t][node],
                              right[t][node])
            node = torch.where(left[t][node] >= 0, nxt, node)
        if counts[t]:
            n_weak += alive.sum(dim=1)
        Hs = Hs + torch.where(alive, pred[t][node], zero)
        alive = alive & (Hs >= float(theta[t]))
    return Hs, alive, n_weak.to(torch.int32)


def cascade_survivor_counts(canvas: torch.Tensor, casc: Cascade,
                            window: Tuple[int, int],
                            valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, int]:
    """``(counts, n_weak)``: the (T,) int64 windows alive entering each
    stage of a (C, H, W) canvas, and the weak evaluations on active stages
    (plain torch on any device; the JAX package has no kernel here)."""
    batched, cv, valid = _grid_args(canvas, casc, window, valid)
    h = casc.host
    _, _, n_weak, entering = lockstep(cv, valid, h, h["theta"].tolist(),
                                      casc.n_stages, h["active"].tolist())
    return entering.sum(dim=1), int(n_weak.sum())


def cascade_predict_samples(x: torch.Tensor, casc: Cascade, meta: CascadeMeta,
                            valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascade scores of (N, m, n, C) window samples (plain torch): ``(H,
    mask)`` with -inf for rejected samples.  Each tree is routed
    ``meta.depth`` steps (leaves route to themselves), as in JAX."""
    depth = max(meta.depth, 1)
    N, m, n, C = x.shape
    xf = x.reshape(N, m * n * C).to(torch.float32)
    fidx = ((casc.fr * n + casc.fc) * C + casc.fch).long()
    H = torch.zeros(N, dtype=torch.float32, device=x.device)
    mask = torch.ones(N, dtype=torch.bool, device=x.device) if valid is None \
        else valid.bool().clone()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    left, right = casc.left.long(), casc.right.long()
    for t in range(casc.n_stages):
        node = torch.zeros(N, dtype=torch.long, device=x.device)
        for _ in range(depth):
            v = torch.gather(xf, 1, fidx[t][node].unsqueeze(1))[:, 0]
            lft, rgt = left[t][node], right[t][node]
            nxt = torch.where(v <= casc.thr[t][node], lft, rgt)
            node = torch.where(lft < 0, node, nxt)
        H = H + torch.where(mask, casc.pred[t][node], zero)
        mask &= H >= casc.theta[t]
    return torch.where(mask, H, torch.full_like(H, float("-inf"))), mask
