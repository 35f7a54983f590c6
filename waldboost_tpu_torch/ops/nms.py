"""Survivor extraction, compaction and greedy NMS on the device.

Counterparts of ``waldboost_tpu/ops/nms.py::extract_detections_masked``,
``extract_detections_rowwise``, ``topk_detections``, ``iou_matrix_device``
and ``nms_device`` (the JAX package has no Pallas kernel here), of the
exact ``jax.lax.approx_max_k(masked, cap, recall_target=1.0)`` of
two-phase serving (``waldboost_tpu/parallel/detect.py:759``) and of its
final ``lax.top_k`` (``:767``).

Every top-k of the port's extractions goes through kernel S2
(``csrc/compact.cu``, one launch, no host synchronization) on a CUDA
tensor and :func:`topk_masked_plain` (a stable sort) on a CPU tensor:
:func:`topk_masked` for the compaction and the top-k alone, and
:func:`extract_detections`, whose boxes, validity and count S2 writes in
the same launch on the card (:func:`origin_boxes` after the sort on the
CPU).
Every greedy NMS goes through :func:`nms`: kernel S3 (``csrc/nms.cu``,
one launch for the batch, no host read) on a CUDA tensor, the loop
:func:`nms_plain` on a CPU tensor.

Extraction is an exact top-k: candidates are ordered by score descending,
then by flat window-origin index ascending (a stable sort), so ``count ==
-1`` means capacity overflow only.  Greedy NMS picks the best remaining
candidate (lowest index among equal scores), keeps it and drops every
remaining candidate with ``iou > thr``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .._build import entry, launch, launches, on_card
from ..profiling import span, tracing

__all__ = ["extract_detections", "extract_detections_masked",
           "extract_detections_rowwise", "compact_survivors",
           "compact_survivors_plain", "topk_masked", "topk_masked_plain",
           "complete_count", "origin_boxes", "topk_detections",
           "iou_matrix_device", "nms", "nms_plain", "nms_device"]

#: most keys one block of S2 sorts (``kRun`` in csrc/compact.cu); a row
#: with more sorts runs of this many and merges them, in a (B, k) scratch
#: the wrapper allocates when k exceeds it
TOPK_RUN = 2048


def extract_detections(masked: torch.Tensor, count: torch.Tensor,
                       level_id: torch.Tensor, offsets: torch.Tensor,
                       inv_scales: torch.Tensor, window: Tuple[int, int],
                       k: int, with_coords: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Boxes of the k best survivors of a (B, GU, GV) masked map.

    ``level_id`` (GU, GV) int64 level of each origin (-1 outside levels),
    ``offsets`` (L, 2) int64 canvas (y, x) of each level, ``inv_scales``
    (L,) float32.  Returns ``rects (B, k, 4)`` image-space XYXY float32,
    ``scores (B, k)``, ``valid (B, k)`` and ``count (B,)`` int32 (the exact
    survivor count, or -1 when it exceeds k); ``with_coords`` adds each
    entry's canvas origin ``rs``, ``cs`` (B, k) int64 (in bounds where not
    valid too, so crops at them are safe).

    On a CUDA tensor this is one launch of kernel S2 with its box
    epilogue (counted under ``compact`` and ``compact/boxes``), and the
    tables must be as above, ``count`` int32, all on the map's device
    (ValueError otherwise); on a CPU tensor :func:`topk_masked_plain` and
    :func:`origin_boxes`, which take what their torch operations take.
    The two agree bitwise.
    """
    B, gu, gv = masked.shape
    k_eff = min(k, gu * gv)
    _, flat, _ = _topk_args(masked, k_eff, None, "topk_masked")
    extract = _extract_on_card if on_card(flat, "topk_masked") and B \
        and k_eff else _extract_plain
    rects, scores, valid, count, idx = extract(
        flat, count, level_id, offsets, inv_scales, window, k_eff, gv)
    if with_coords:
        return (rects, scores, valid, count,
                torch.div(idx, gv, rounding_mode="floor"), idx % gv)
    return rects, scores, valid, count


def _extract_plain(flat, count, level_id, offsets, inv_scales, window,
                   k: int, gv: int) -> Tuple[torch.Tensor, ...]:
    """``(rects, scores, valid, count, idx)`` of
    :func:`extract_detections` over (B, GU * GV) rows ``flat``: the top-k
    (:func:`topk_masked`), then the count's clamp and
    :func:`origin_boxes` in torch operations."""
    scores, idx, _ = topk_masked(flat, k)
    valid = torch.isfinite(scores)
    count = torch.where(count <= k, count, torch.full_like(count, -1))
    rects = origin_boxes(torch.div(idx, gv, rounding_mode="floor"), idx % gv,
                         valid, level_id, offsets, inv_scales, window)
    return rects, scores, valid, count, idx


def _box_tables(flat: torch.Tensor, count: torch.Tensor,
                level_id: torch.Tensor, offsets: torch.Tensor,
                inv_scales: torch.Tensor, gv: int) -> Tuple[torch.Tensor, ...]:
    """``(count, level_id, offsets, inv_scales)`` contiguous, for S2's
    box epilogue over the (B, GU * GV) rows ``flat``; ValueError unless
    they are (B,) int32, (GU, GV) int64, (L, 2) int64 and (L,) float32
    with L at least 1, on ``flat``'s device."""
    B, n = flat.shape
    n_lev = max(offsets.shape[0] if offsets.dim() == 2 else 0, 1)
    for name, t, dtype, shape, what in (
            ("count", count, torch.int32, (B,), f"({B},)"),
            ("level_id", level_id, torch.int64, (n // gv, gv),
             f"({n // gv}, {gv})"),
            ("offsets", offsets, torch.int64, (n_lev, 2), "(L, 2), L >= 1,"),
            ("inv_scales", inv_scales, torch.float32, (n_lev,), "(L,)")):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != flat.device:
            raise ValueError(f"extract_detections: {name} must be a {what} "
                             f"{dtype} tensor on the map's device "
                             f"{flat.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return tuple(_contiguous(t) for t in (count, level_id, offsets,
                                          inv_scales))


def _extract_on_card(flat, count, level_id, offsets, inv_scales, window,
                     k: int, gv: int) -> Tuple[torch.Tensor, ...]:
    """``(rects, scores, valid, count, idx)`` of
    :func:`extract_detections` over B >= 1 rows ``flat`` on the card, k
    >= 1: one launch of S2 with its box epilogue."""
    count, level_id, offsets, inv_scales = _box_tables(
        flat, count, level_id, offsets, inv_scales, gv)
    B, dev = flat.shape[0], flat.device
    rects = torch.empty((B, k, 4), dtype=torch.float32, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    valid = torch.empty((B, k), dtype=torch.bool, device=dev)
    count_out = torch.empty(B, dtype=torch.int32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int64, device=dev)
    _launch_topk(flat, None, k, scores, idx, None, (
        level_id.data_ptr(), offsets.data_ptr(), inv_scales.data_ptr(),
        count.data_ptr(), gv, float(window[0]), float(window[1]),
        rects.data_ptr(), valid.data_ptr(), count_out.data_ptr()))
    launches["compact/boxes"] += 1
    return rects, scores, valid, count_out, idx


def extract_detections_masked(masked: torch.Tensor, count,
                              level_id: torch.Tensor, offsets: torch.Tensor,
                              inv_scales: torch.Tensor, window, k: int = 256,
                              with_coords: bool = False
                              ) -> Tuple[torch.Tensor, ...]:
    """:func:`extract_detections` under the JAX package's name and
    parameters: ``masked`` one (GU, GV) map (or a (B, GU, GV) batch),
    ``count`` its survivor count, ``window`` the (m, n) pair (a tensor or
    a sequence).  ``count`` comes back as -1 when it exceeds ``k`` or
    differs from the extracted finite entries; ``with_coords`` adds the
    int32 canvas origins ``rs``, ``cs``."""
    batched = masked.dim() == 3
    mk = masked if batched else masked[None]
    cnt = torch.as_tensor(count, device=mk.device).reshape(-1).to(
        torch.int32)
    if isinstance(window, torch.Tensor):
        window = window.tolist()
    window = tuple(int(v) for v in window)
    rects, scores, valid, cnt, rs, cs = extract_detections(
        mk, cnt, level_id.long(), offsets.long(), inv_scales, window, k,
        with_coords=True)
    cnt, _ = complete_count(scores, cnt, scores.shape[1])
    out = (rects, scores, valid, cnt)
    if with_coords:
        out += (rs.to(torch.int32), cs.to(torch.int32))
    return out if batched else tuple(o[0] for o in out)


def complete_count(scores: torch.Tensor, count: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(count, complete)`` of (B, k) top-k ``scores`` taken for (B,)
    survivor counts ``count``: complete where ``count <= k`` and the
    finite scores number ``count`` (JAX's check in
    ``extract_detections_masked`` and two-phase serving's compaction),
    the count there and -1 elsewhere.  On the device, no sync."""
    got = torch.isfinite(scores).sum(dim=1, dtype=torch.int32)
    complete = (count <= k) & (got == count)
    return torch.where(complete, count, torch.full_like(count, -1)), complete


def origin_boxes(rs, cs, valid, level_id, offsets, inv_scales, window):
    """(..., 4) image-space XYXY float32 boxes of canvas origins ``rs``,
    ``cs`` through the level maps; zeros where not ``valid``."""
    lid = torch.clamp(level_id[rs, cs], min=0)
    x1 = (cs - offsets[lid, 1]).to(torch.float32)
    y1 = (rs - offsets[lid, 0]).to(torch.float32)
    m, n = float(window[0]), float(window[1])
    rects = torch.stack([x1, y1, x1 + n, y1 + m], dim=-1)
    rects = rects * inv_scales[lid].unsqueeze(-1)
    return torch.where(valid.unsqueeze(-1), rects, torch.zeros_like(rects))


def extract_detections_rowwise(hs: torch.Tensor, alive: torch.Tensor,
                               level_id: torch.Tensor, offsets: torch.Tensor,
                               inv_scales: torch.Tensor,
                               window: Tuple[int, int], k_row: int = 16,
                               k: int = 1024) -> Tuple[torch.Tensor, ...]:
    """Boxes of (B, GU, GV) ``hs`` where ``alive``: each grid row's best
    ``k_row`` survivors, then the best ``k`` of those (plain torch).

    Both selections are stable descending sorts, so equal scores keep
    ``lax.top_k``'s order (the lower index first): the result is JAX's
    ``extract_detections_rowwise``.  Returns ``rects (B, k', 4)``,
    ``scores``, ``valid`` (B, k') with ``k' = min(k, GU * min(k_row,
    GV))``, and ``count`` (B,) int32: the survivor count, or -1 when it
    exceeds ``k`` or a row holds more than ``k_row`` survivors."""
    B, gu, gv = hs.shape
    neg_inf = torch.full((), float("-inf"), device=hs.device)
    masked = torch.where(alive, hs, neg_inf)
    count = alive.sum(dim=(1, 2), dtype=torch.int32)
    row_over = alive.sum(dim=2, dtype=torch.int32).amax(dim=1) if gu \
        else torch.zeros_like(count)
    count = torch.where((row_over <= k_row) & (count <= k), count,
                        torch.full_like(count, -1))
    kr = min(k_row, gv)
    cand, cols = torch.sort(masked, dim=2, descending=True, stable=True)
    cand, cols = cand[:, :, :kr].reshape(B, -1), cols[:, :, :kr].reshape(B, -1)
    k_eff = min(k, cand.shape[1])
    scores, sel = torch.sort(cand, dim=1, descending=True, stable=True)
    scores, sel = scores[:, :k_eff], sel[:, :k_eff]
    rs = torch.div(sel, kr, rounding_mode="floor")
    cs = torch.gather(cols, 1, sel)
    valid = torch.isfinite(scores)
    rects = origin_boxes(rs, cs, valid, level_id, offsets, inv_scales, window)
    return rects, scores, valid, count


_VP, _CI, _CL, _CF = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
#: values, alive, B, n, k, scores, idx, present, ws, ws words, runs; the
#: box epilogue's level_id, offsets, inv_scales, count, gv, window m and
#: n, rects, valid, count out; stream
_TOPK_ARGS = (_VP, _VP, _CI, _CL, _CI, _VP, _VP, _VP, _VP, _CL, _VP,
              _VP, _VP, _VP, _VP, _CI, _CF, _CF, _VP, _VP, _VP, _VP)
#: the epilogue's arguments when there is none (level_id null)
_NO_BOXES = (None, None, None, None, 0, 0.0, 0.0, None, None, None)
#: wb_topk_workspace's int32 words for (B, n), asked once a shape
_TOPK_WORDS: Dict[Tuple[int, int], int] = {}
#: rects, scores, valid, B, K, thr, keep, stream
_NMS_ARGS = (_VP, _VP, _VP, _CI, _CI, ctypes.c_float, _VP, _VP)


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where contiguous (no torch operation), else a
    contiguous copy."""
    return t if t.is_contiguous() else t.contiguous()


def _topk_args(values: torch.Tensor, k: int, alive, what: str):
    """``(batched, flat, mask)``: ``values`` (and ``alive``) as contiguous
    (B, N) rows, the first dimension the batch unless ``values`` is 1-D."""
    if values.dtype != torch.float32 or values.dim() < 1:
        raise ValueError(f"{what}: the map must be float32")
    batched = values.dim() > 1
    rows = lambda x: _contiguous(x.reshape(x.shape[0], -1) if batched
                                 else x.reshape(1, -1))
    flat = rows(values)
    mask = None
    if alive is not None:
        if alive.shape != values.shape or alive.dtype != torch.bool \
                or alive.device != values.device:
            raise ValueError(f"{what}: alive must be a bool tensor of the "
                             f"map's shape and device")
        mask = rows(alive)
    if not 0 <= int(k) <= flat.shape[1]:
        raise ValueError(f"{what}: k {k} outside [0, {flat.shape[1]}]")
    return batched, flat, mask


def _unbatch(batched, *outs):
    return outs if batched else tuple(o[0] for o in outs)


def topk_masked(values: torch.Tensor, k: int,
                alive: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scores, idx, present)``: per row of a (B, ...) score map, the
    first ``k`` entries of its stable descending sort, flattened: the
    finite entries by score descending, then flat index ascending; after
    them, when fewer than ``k`` are finite, the others by index.  With
    ``alive`` (a bool map of the same shape) the map is ``values`` where
    alive and -inf elsewhere.  Returns (B, k) float32 scores, int64 flat
    indices and the (B,) int32 count of entries present (finite, or
    alive with ``alive``); a 1-D map gives one row, unbatched.

    Kernel S2 (``csrc/compact.cu``) on a CUDA tensor: one launch, output
    shapes fixed by ``k``, nothing read back by the host.
    :func:`topk_masked_plain` on a CPU tensor.  The two agree bitwise on
    any map (non-finite values of either sign and NaN rank as -inf)."""
    what = "topk_masked"
    batched, flat, mask = _topk_args(values, k, alive, what)
    if not on_card(flat, what):
        return topk_masked_plain(values, k, alive)
    B, n = flat.shape
    k = int(k)
    dev = flat.device
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int64, device=dev)
    if k == 0 or B == 0:
        present = (torch.isfinite(flat) if mask is None else mask).sum(
            dim=1, dtype=torch.int32)
        return _unbatch(batched, scores, idx, present)
    present = torch.empty(B, dtype=torch.int32, device=dev)
    _launch_topk(flat, mask, k, scores, idx, present)
    return _unbatch(batched, scores, idx, present)


def _launch_topk(flat, mask, k: int, scores, idx, present,
                 boxes=_NO_BOXES) -> None:
    """Launch S2 over (B, n) rows ``flat`` (``mask`` their alive map or
    None) into ``scores``, ``idx`` and ``present`` (None: into the
    scratch), with the box epilogue's arguments of ``_TOPK_ARGS``
    (``boxes``).  One int32 scratch tensor holds the workspace, the sorted
    runs when k > TOPK_RUN (on 8 bytes: the workspace's words are even)
    and the unwanted ``present``."""
    B, n = flat.shape
    words = _TOPK_WORDS.get((B, n))
    if words is None:
        words = _TOPK_WORDS[B, n] = int(entry(
            "compact", "wb_topk_workspace", (_CI, _CL), _CL)(B, n))
    runs = 2 * B * k if k > TOPK_RUN else 0
    ws = torch.empty(words + runs + (B if present is None else 0),
                     dtype=torch.int32, device=flat.device)
    at = ws.data_ptr()
    launch("compact", entry("compact", "wb_topk", _TOPK_ARGS), flat.device,
           flat.data_ptr(), None if mask is None else mask.data_ptr(), B, n,
           k, scores.data_ptr(), idx.data_ptr(),
           at + 4 * (words + runs) if present is None else present.data_ptr(),
           at, words, at + 4 * words if runs else None, *boxes)


def topk_masked_plain(values: torch.Tensor, k: int,
                      alive: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch version of :func:`topk_masked` (kernel S2): one stable
    descending sort of each row with every non-finite value as -inf and
    -0 as +0, cut to ``k``; the scores are the map's values there."""
    batched, flat, mask = _topk_args(values, k, alive, "topk_masked")
    v = flat if mask is None else torch.where(mask, flat, float("-inf"))
    key = torch.where(torch.isfinite(v), v + 0.0, float("-inf"))
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices
    idx = idx[:, :int(k)]
    present = (torch.isfinite(flat) if mask is None else mask).sum(
        dim=1, dtype=torch.int32)
    return _unbatch(batched, torch.gather(v, 1, idx), idx, present)


def compact_survivors(masked: torch.Tensor, count: torch.Tensor, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores, idx)``: per image of a (B, ...) masked score map (finite
    where a window survived, -inf elsewhere) the ``cap`` best entries of
    the flattened map, by score descending, then flat index ascending:
    the stable descending sort of the map cut to ``cap`` (JAX's exact
    ``approx_max_k``), as (B, cap) float32 scores and int64 flat indices.
    :func:`topk_masked`: kernel S2 on a CUDA tensor, with no host
    synchronization.  ``count`` (B,), each image's survivor count, is not
    read: a caller that holds one compares it with the entries captured
    on the device (``TwoPhaseDetector.finish``, JAX's ``complete``)."""
    return topk_masked(masked, cap)[:2]


def compact_survivors_plain(masked: torch.Tensor, count: torch.Tensor,
                            cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch version of :func:`compact_survivors` (kernel S2): the
    stable descending sort of the whole flattened map, cut to ``cap``."""
    return topk_masked_plain(masked, cap)[:2]


def topk_detections(hs: torch.Tensor, alive: torch.Tensor,
                    level_id: torch.Tensor, offsets: torch.Tensor,
                    inv_scales: torch.Tensor, window: Tuple[int, int],
                    k: int = 1024) -> Tuple[torch.Tensor, ...]:
    """``(rects, scores, valid)`` of the k best survivors of (B, GU, GV)
    ``hs`` and ``alive`` maps: :func:`extract_detections` over ``hs`` where
    alive and -inf elsewhere (the order of ``lax.top_k``: lowest flat index
    first among equal scores)."""
    masked = torch.where(alive, hs, float("-inf"))
    rects, scores, valid, _ = extract_detections(
        masked, alive.sum(dim=(1, 2), dtype=torch.int32), level_id, offsets,
        inv_scales, window, k)
    return rects, scores, valid


def iou_matrix_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) float32 IoU of (N, 4) and (M, 4) XYXY rects, 0 where the
    union is empty."""
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = lambda r: torch.clamp(r[:, 2] - r[:, 0], min=0) \
        * torch.clamp(r[:, 3] - r[:, 1], min=0)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _iou_with(rects: torch.Tensor, area: torch.Tensor,
              i: torch.Tensor) -> torch.Tensor:
    """(B, K) IoU of box ``i[b]`` with every box of image b, float32."""
    box = torch.gather(rects, 1, i.view(-1, 1, 1).expand(-1, 1, 4))
    x1 = torch.maximum(box[..., 0], rects[..., 0])
    y1 = torch.maximum(box[..., 1], rects[..., 1])
    x2 = torch.minimum(box[..., 2], rects[..., 2])
    y2 = torch.minimum(box[..., 3], rects[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    union = torch.gather(area, 1, i.view(-1, 1)) + area - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(rects: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over (B, K) candidate sets (rects (B, K, 4) XYXY);
    returns keep (B, K) bool: while a valid candidate remains, the best
    remaining one (the highest score, NaN above all, the lower index on a
    tie) is kept and every remaining candidate whose IoU with it exceeds
    ``iou_threshold`` (as a float32) is dropped.

    Kernel S3 (``csrc/nms.cu``) on a CUDA tensor: one launch for the
    batch, nothing read back by the host; rects and scores must be
    float32 and valid bool there (ValueError otherwise).
    :func:`nms_plain` on a CPU tensor, which takes any dtypes the loop
    takes.  The two agree bitwise on every input on which the plain loop
    ends."""
    if not on_card(scores, "nms"):
        return nms_plain(rects, scores, valid, iou_threshold)
    if scores.dim() != 2 or rects.shape != (*scores.shape, 4) \
            or valid.shape != scores.shape:
        raise ValueError(f"nms: rects {tuple(rects.shape)}, scores "
                         f"{tuple(scores.shape)} and valid "
                         f"{tuple(valid.shape)} are not (B, K, 4), (B, K), "
                         f"(B, K)")
    if rects.dtype != torch.float32 or scores.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise ValueError("nms: rects and scores must be float32, valid bool")
    if rects.device != scores.device or valid.device != scores.device:
        raise ValueError("nms: rects, scores and valid on different devices")
    B, K = scores.shape
    dev = scores.device
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0 or K == 0:
        return keep
    rects, scores, valid = (t.contiguous() for t in (rects, scores, valid))
    launch("nms", entry("nms", "wb_nms", _NMS_ARGS), dev, rects.data_ptr(),
           scores.data_ptr(), valid.data_ptr(), B, K, float(iou_threshold),
           keep.data_ptr())
    return keep


def nms_plain(rects: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """Plain-torch version of :func:`nms` (kernel S3): the greedy loop,
    one round a kept box of the fullest image, plus one test that ends
    it.  While a torch profiler runs, each round is a ``wb.nms.round``
    span and each test's read of the device a ``wb.sync`` span: R rounds
    and R + 1 reads a call."""
    traced = tracing()
    K = scores.shape[1]
    keep = torch.zeros_like(valid)
    area = torch.clamp(rects[..., 2] - rects[..., 0], min=0) \
        * torch.clamp(rects[..., 3] - rects[..., 1], min=0)
    col = torch.arange(K, device=scores.device).unsqueeze(0)
    # filled on the device: a tensor made from a host value would be a
    # blocking copy
    neg_inf = torch.full((), float("-inf"), device=scores.device)
    remaining = valid.clone()
    while True:
        left = remaining.any()
        with span("wb.sync", traced):
            more = bool(left)
        if not more:
            return keep
        with span("wb.nms.round", traced):
            i = torch.argmax(torch.where(remaining, scores, neg_inf), dim=1)
            active = torch.gather(remaining, 1, i.view(-1, 1))
            picked = col == i.view(-1, 1)
            sup = (_iou_with(rects, area, i) > iou_threshold) | picked
            remaining &= ~(active & sup)
            keep |= active & picked


def nms_device(rects: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_threshold: float = 0.5
               ) -> torch.Tensor:
    """:func:`nms` under the JAX package's name and parameters: one (K,)
    candidate set (rects (K, 4)) or a (B, K) batch; returns keep of the
    same shape.  A box at an IoU of exactly the threshold with a kept one
    is not suppressed, as in the host NMS.  On a CUDA tensor rects and
    scores must be float32 and valid bool, as :func:`nms` says."""
    if scores.dim() == 1:
        return nms(rects[None], scores[None], valid[None],
                   float(iou_threshold))[0]
    return nms(rects, scores, valid, float(iou_threshold))
