"""Survivor extraction and greedy NMS on the device (plain torch).

Counterparts of ``waldboost_tpu/ops/nms.py::extract_detections_masked``,
``topk_detections`` and ``nms_device``; the JAX package has no Pallas
kernel here.

Extraction is an exact top-k: candidates are ordered by score descending,
then by flat window-origin index ascending (a stable sort), so ``count ==
-1`` means capacity overflow only.  Greedy NMS picks the best remaining
candidate (lowest index among equal scores), keeps it and drops every
remaining candidate with ``iou > thr``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["extract_detections", "topk_detections", "nms", "nms_device"]


def extract_detections(masked: torch.Tensor, count: torch.Tensor,
                       level_id: torch.Tensor, offsets: torch.Tensor,
                       inv_scales: torch.Tensor, window: Tuple[int, int],
                       k: int) -> Tuple[torch.Tensor, ...]:
    """Boxes of the k best survivors of a (B, GU, GV) masked map.

    ``level_id`` (GU, GV) int64 level of each origin (-1 outside levels),
    ``offsets`` (L, 2) int64 canvas (y, x) of each level, ``inv_scales``
    (L,) float32.  Returns ``rects (B, k, 4)`` image-space XYXY float32,
    ``scores (B, k)``, ``valid (B, k)`` and ``count (B,)`` int32 (the exact
    survivor count, or -1 when it exceeds k).
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
    lid = torch.clamp(level_id[rs, cs], min=0)
    x1 = (cs - offsets[lid, 1]).to(torch.float32)
    y1 = (rs - offsets[lid, 0]).to(torch.float32)
    m, n = float(window[0]), float(window[1])
    rects = torch.stack([x1, y1, x1 + n, y1 + m], dim=2)
    rects = rects * inv_scales[lid].unsqueeze(2)
    rects = torch.where(valid.unsqueeze(2), rects, torch.zeros_like(rects))
    return rects, scores, valid, count


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


#: the JAX package's name for :func:`nms`
nms_device = nms
