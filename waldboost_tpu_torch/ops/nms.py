"""Survivor extraction, compaction and greedy NMS on the device.

Counterparts of ``waldboost_tpu/ops/nms.py::extract_detections_masked``,
``extract_detections_rowwise``, ``topk_detections``, ``iou_matrix_device``
and ``nms_device``
(plain torch; the JAX package has no Pallas kernel here), and of the
exact ``jax.lax.approx_max_k(masked, cap, recall_target=1.0)`` of
two-phase serving (``waldboost_tpu/parallel/detect.py:759``):
:func:`compact_survivors`, kernel S2 (``csrc/compact.cu``) on a CUDA
tensor, its plain version on a CPU tensor.

Extraction is an exact top-k: candidates are ordered by score descending,
then by flat window-origin index ascending (a stable sort), so ``count ==
-1`` means capacity overflow only.  Greedy NMS picks the best remaining
candidate (lowest index among equal scores), keeps it and drops every
remaining candidate with ``iou > thr``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import check, load_library

__all__ = ["extract_detections", "extract_detections_masked",
           "extract_detections_rowwise", "compact_survivors",
           "compact_survivors_plain", "origin_boxes", "topk_detections",
           "iou_matrix_device", "nms", "nms_device"]

#: kernel launches made by :func:`compact_survivors` (S2)
compact_launches = 0
#: entries of one block of S2's count and write passes (csrc/compact.cu)
COMPACT_TILE = 4096


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
    """
    B, gu, gv = masked.shape
    flat = masked.reshape(B, gu * gv)
    k_eff = min(k, gu * gv)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k_eff], idx[:, :k_eff]
    valid = torch.isfinite(scores)
    count = torch.where(count <= k_eff, count, torch.full_like(count, -1))
    rs = torch.div(idx, gv, rounding_mode="floor")
    cs = idx % gv
    rects = origin_boxes(rs, cs, valid, level_id, offsets, inv_scales, window)
    if with_coords:
        return rects, scores, valid, count, rs, cs
    return rects, scores, valid, count


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
    got = valid.sum(dim=1, dtype=torch.int32)
    cnt = torch.where(got == cnt, cnt, torch.full_like(cnt, -1))
    out = (rects, scores, valid, cnt)
    if with_coords:
        out += (rs.to(torch.int32), cs.to(torch.int32))
    return out if batched else tuple(o[0] for o in out)


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
    neg_inf = torch.tensor(float("-inf"), device=hs.device)
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


def _flat(masked: torch.Tensor, cap: int):
    if masked.dtype != torch.float32 or masked.dim() < 1:
        raise ValueError("compact_survivors: masked must be a float32 map")
    batched = masked.dim() > 1
    flat = (masked.reshape(masked.shape[0], -1) if batched
            else masked.reshape(1, -1)).contiguous()
    if not 0 <= int(cap) <= flat.shape[1]:
        raise ValueError(f"compact_survivors: cap {cap} outside [0, "
                         f"{flat.shape[1]}]")
    return batched, flat


def compact_survivors(masked: torch.Tensor, count: torch.Tensor, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores, idx)``: per image of a (B, ...) masked score map (finite
    where a window survived, -inf elsewhere) the ``cap`` best entries of
    the flattened map, by score descending, then flat index ascending:
    the stable descending sort of the map cut to ``cap`` (JAX's exact
    ``approx_max_k``), as (B, cap) float32 scores and int64 flat indices.
    ``count`` (B,) is each image's survivor count (its finite entries).

    On a CUDA tensor, kernel S2 (``csrc/compact.cu``) writes the finite
    entries in index order, then the first non-finite ones, into ``cap``
    slots, or, when an image has more than ``cap`` survivors, into as
    many slots as the largest count; a stable sort of those slots then
    orders them.  Choosing the slots reads the counts on the host (one
    synchronization); a count that differs from the map's finite entries
    raises."""
    batched, flat = _flat(masked, cap)
    if flat.device.type == "cpu":
        return compact_survivors_plain(masked, count, cap)
    if flat.device.type != "cuda":
        raise ValueError(f"compact_survivors: unsupported device "
                         f"{flat.device}")
    global compact_launches
    B, n = flat.shape
    dev = flat.device
    n_blocks = -(-n // COMPACT_TILE)
    offsets = torch.empty((B, n_blocks), dtype=torch.int32, device=dev)
    totals = torch.zeros(B, dtype=torch.int32, device=dev)
    lib = load_library("compact")
    _signature(lib)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        check(lib.wb_compact_count(flat.data_ptr(), B, n, n_blocks,
                                   offsets.data_ptr(), totals.data_ptr(),
                                   stream), "wb_compact_count kernel")
        both = torch.stack([totals, count.reshape(-1).to(dev, torch.int32)
                            ]).cpu()
        if not torch.equal(both[0], both[1]):
            raise ValueError(f"compact_survivors: counts {both[1].tolist()} "
                             f"differ from the map's survivors "
                             f"{both[0].tolist()}")
        n_out = max(int(cap), int(both[0].max()) if B else 0)
        scores = torch.empty((B, n_out), dtype=torch.float32, device=dev)
        idx = torch.empty((B, n_out), dtype=torch.int64, device=dev)
        check(lib.wb_compact_write(flat.data_ptr(), B, n, n_blocks,
                                   offsets.data_ptr(), totals.data_ptr(),
                                   n_out, scores.data_ptr(), idx.data_ptr(),
                                   stream), "wb_compact_write kernel")
    compact_launches += 1
    scores, perm = torch.sort(scores, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :cap], torch.gather(idx, 1, perm[:, :cap])
    return (scores, idx) if batched else (scores[0], idx[0])


def _signature(lib) -> None:
    _VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if lib.wb_compact_count.argtypes is None:
        lib.wb_compact_count.argtypes = [_VP, _CI, _CL, _CI, _VP, _VP, _VP]
        lib.wb_compact_count.restype = _CI
        lib.wb_compact_write.argtypes = [_VP, _CI, _CL, _CI, _VP, _VP, _CI,
                                         _VP, _VP, _VP]
        lib.wb_compact_write.restype = _CI


def compact_survivors_plain(masked: torch.Tensor, count: torch.Tensor,
                            cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch version of :func:`compact_survivors` (kernel S2): the
    stable descending sort of the whole flattened map, cut to ``cap``."""
    batched, flat = _flat(masked, cap)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :cap], idx[:, :cap]
    return (scores, idx) if batched else (scores[0], idx[0])


def topk_detections(hs: torch.Tensor, alive: torch.Tensor,
                    level_id: torch.Tensor, offsets: torch.Tensor,
                    inv_scales: torch.Tensor, window: Tuple[int, int],
                    k: int = 1024) -> Tuple[torch.Tensor, ...]:
    """``(rects, scores, valid)`` of the k best survivors of (B, GU, GV)
    ``hs`` and ``alive`` maps: :func:`extract_detections` over ``hs`` where
    alive and -inf elsewhere (the order of ``lax.top_k``: lowest flat index
    first among equal scores)."""
    masked = torch.where(alive, hs, torch.tensor(float("-inf"),
                                                 device=hs.device))
    rects, scores, valid, _ = extract_detections(
        masked, alive.sum(dim=(1, 2)), level_id, offsets, inv_scales, window,
        k)
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
    """Greedy NMS over (B, K) candidate sets; returns keep (B, K) bool.
    The loop runs once per kept box of the fullest image, plus one."""
    K = scores.shape[1]
    keep = torch.zeros_like(valid)
    area = torch.clamp(rects[..., 2] - rects[..., 0], min=0) \
        * torch.clamp(rects[..., 3] - rects[..., 1], min=0)
    col = torch.arange(K, device=scores.device).unsqueeze(0)
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    remaining = valid.clone()
    while bool(remaining.any()):
        i = torch.argmax(torch.where(remaining, scores, neg_inf), dim=1)
        active = torch.gather(remaining, 1, i.view(-1, 1))
        picked = col == i.view(-1, 1)
        sup = (_iou_with(rects, area, i) > iou_threshold) | picked
        remaining &= ~(active & sup)
        keep |= active & picked
    return keep


def nms_device(rects: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_threshold: float = 0.5
               ) -> torch.Tensor:
    """:func:`nms` under the JAX package's name and parameters: one (K,)
    candidate set (rects (K, 4)) or a (B, K) batch; returns keep of the
    same shape.  A box at an IoU of exactly the threshold with a kept one
    is not suppressed, as in the host NMS."""
    if scores.dim() == 1:
        return nms(rects[None], scores[None], valid[None],
                   float(iou_threshold))[0]
    return nms(rects, scores, valid, float(iou_threshold))
