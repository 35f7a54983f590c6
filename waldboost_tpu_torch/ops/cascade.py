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
``wb_cascade_generic``).  Per window origin set in the valid mask and per
stage in order: ``n_weak`` counts the stage if it is active, the tree
walk adds the leaf to ``hs`` in f32 from 0, and the window dies when
``hs >= theta`` fails.  A dead window keeps the ``hs`` of the stage it died
in; an origin outside the mask keeps 0.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Cascade", "CascadeMeta", "NEG_INF", "MAX_COMPLETE_DEPTH",
           "NODE_KEYS", "check_children", "tree_depth", "stage_tables",
           "stack_node_table", "cascade_from_stages", "lockstep",
           "cascade_response_grid", "cascade_response_grid_plain",
           "cascade_survivor_counts", "cascade_predict_samples"]

#: kernel launches made by :func:`cascade_response_grid`
cascade_generic_launches = 0

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
# kernel B6
# ---------------------------------------------------------------------------

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
    if cv.device.type == "cpu":
        return _unbatch(batched, *_plain(cv, casc, valid))
    if cv.device.type != "cuda":
        raise ValueError(f"cascade: unsupported device {cv.device}")
    from .cascade_static import launch_response
    global cascade_generic_launches
    B = cv.shape[0]
    gu, gv = valid.shape
    hs = torch.zeros((B, gu, gv), dtype=torch.float32, device=cv.device)
    alive = torch.zeros((B, gu, gv), dtype=torch.bool, device=cv.device)
    n_weak = torch.zeros(B, dtype=torch.int32, device=cv.device)
    if B and gu and gv:
        launch_response("wb_cascade_generic", cv, valid,
                        [getattr(casc, k) for k in NODE_KEYS],
                        casc.theta, casc.n_stages, hs, alive, n_weak,
                        active=casc.active)
        cascade_generic_launches += 1
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
