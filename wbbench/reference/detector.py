"""The plain reference of batched WaldBoost detection with boxes and NMS.

What it computes for a (B, H, W) uint8 batch, from the model file and the
frames alone:

1. the channel canvas: each pyramid level computed on its own
   (:mod:`.image`) and written at its place in the packed canvas
   (:mod:`.pyramid`), zero elsewhere, float32;
2. the cascade: every valid window origin walks each stage's tree from
   node 0 to a leaf (``canvas[b, ch, r + fr, c + fc] <= thr`` goes left),
   adds the leaf to its float32 score from 0, and is rejected when the
   score falls under the stage's finite theta; ``n_weak`` counts the
   stages each window entered;
3. extraction: each image's survivors by score descending, then by flat
   origin index ascending, the first ``min(k, GU * GV)`` of them, as
   image-space XYXY boxes (the origin minus its level's offset, plus the
   window, times the level's inverse scale, in float32); empty slots have
   score -inf and a zero box; ``count`` is the survivor count, or -1 when
   it exceeds the slots;
4. greedy NMS in that order: a kept box drops every later box whose IoU
   with it (float32) exceeds the threshold.

The walk follows each window alone, so it also records which canvas
values some evaluated node read: :mod:`wbbench.roofline` counts bytes from
that.  ``control`` computes the canvas in a lower precision than the
configuration states (``"bf16"``: rounded to bfloat16; ``"int4"``: integer
channels cut to their top 4 bits), the comparison's control.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .image import CHANNELS, level_channels, octaves
from .model_file import read_model
from .pyramid import pack, pyramid_plan

__all__ = ["ReferenceDetector", "OUTPUTS"]

#: the five outputs of a batch, in the detector's order
OUTPUTS = ("rects", "scores", "keep", "count", "n_weak")


class ReferenceDetector:
    """The reference for one model file and frame size on ``device``."""

    def __init__(self, model_path: str, frame_hw: Tuple[int, int], k: int,
                 nms_iou: Optional[float], device="cpu",
                 control: Optional[str] = None):
        if control not in (None, "bf16", "int4"):
            raise ValueError(f"unknown control {control!r}")
        self.model = mdl = read_model(model_path)
        self.device = torch.device(device)
        self.frame_hw = tuple(int(v) for v in frame_hw)
        self.k = int(k)
        self.nms_iou = nms_iou
        self.control = control
        self.funcs = mdl.func.split("+")
        self.n_channels = sum(CHANNELS[f][0] for f in self.funcs)
        if self.n_channels != mdl.shape[2]:
            raise ValueError("model window and channel function disagree")
        halo = max(CHANNELS[f][1] for f in self.funcs)
        self.window = (mdl.shape[0], mdl.shape[1])
        plan = pyramid_plan(*self.frame_hw, mdl.shrink, mdl.n_per_oct)
        self.packing = pack(plan, self.window, halo, mdl.shrink)
        self.valid = self.packing.valid_mask(self.window)
        self.level_id = self.packing.level_id(self.window)
        self.offsets = np.array([(p.y, p.x) for p in self.packing.levels],
                                np.int64).reshape(-1, 2)
        self.inv_scales = np.array([1.0 / p.level.scale
                                    for p in self.packing.levels], np.float32)
        nn = max(len(s["threshold"]) for s in mdl.stages)
        tab = {key: np.zeros((len(mdl.stages), nn), dt) for key, dt in
               (("fr", np.int64), ("fc", np.int64), ("fch", np.int64),
                ("thr", np.float32), ("pred", np.float32))}
        tab["left"] = np.full((len(mdl.stages), nn), -1, np.int64)
        tab["right"] = np.full((len(mdl.stages), nn), -1, np.int64)
        for t, s in enumerate(mdl.stages):
            kk = len(s["threshold"])
            f = np.maximum(s["feature"], 0)
            tab["fr"][t, :kk], tab["fc"][t, :kk], tab["fch"][t, :kk] = f.T
            tab["thr"][t, :kk] = s["threshold"]
            tab["pred"][t, :kk] = s["prediction"]
            tab["left"][t, :kk] = s["left"]
            tab["right"][t, :kk] = s["right"]
        self.depth = _depth(tab["left"], tab["right"])
        self.tab = {key: torch.as_tensor(v, device=self.device)
                    for key, v in tab.items()}
        self.theta = [float(t) if np.isfinite(t) else float("-inf")
                      for t in mdl.theta]
        self.stage_nodes = [len(s["threshold"]) for s in mdl.stages]

    # -- 1. canvas ----------------------------------------------------------
    def canvas(self, frames: torch.Tensor) -> torch.Tensor:
        mdl = self.model
        B = frames.shape[0]
        cv = torch.zeros((B, self.n_channels, self.packing.canvas_h,
                          self.packing.canvas_w), dtype=torch.float32,
                         device=self.device)
        if not self.packing.levels:
            return cv
        octs = octaves(frames.to(self.device),
                       max(p.level.octave for p in self.packing.levels) + 1)
        for p in self.packing.levels:
            lv = p.level
            cv[:, :, p.y:p.y + lv.out_height, p.x:p.x + lv.out_width] = \
                level_channels(octs[lv.octave], lv.height, lv.width,
                               mdl.shrink, mdl.smooth, self.funcs)
        if self.control == "bf16":
            cv = cv.to(torch.bfloat16).to(torch.float32)
        elif self.control == "int4":
            cv = torch.floor(cv / 16.0) * 16.0
        return cv

    # -- 2. cascade ---------------------------------------------------------
    def walk(self, cv: torch.Tensor):
        """``(b, r, c, hs)`` of the survivors (image-major, then flat
        origin ascending), per-image ``n_weak``, and the walk's counts:
        canvas values read, node evaluations, stage entries and the
        stages that some window entered."""
        B, C, Hc, Wc = cv.shape
        dev = self.device
        vr, vc = np.nonzero(self.valid)
        n0 = len(vr)
        b = torch.arange(B, device=dev).repeat_interleave(n0)
        r = torch.as_tensor(vr, device=dev).repeat(B)
        c = torch.as_tensor(vc, device=dev).repeat(B)
        hs = torch.zeros(b.shape, dtype=torch.float32, device=dev)
        flat = cv.reshape(-1)
        read = torch.zeros(flat.shape, dtype=torch.bool, device=dev)
        n_weak = torch.zeros(B, dtype=torch.int64, device=dev)
        evals = torch.zeros((), dtype=torch.int64, device=dev)
        tab = self.tab
        entered = 0
        for t in range(len(self.theta)):
            if b.numel() == 0:
                break
            entered += 1
            n_weak += torch.bincount(b, minlength=B)
            node = torch.zeros_like(b)
            for _ in range(self.depth):
                left = tab["left"][t][node]
                inner = left >= 0
                addr = ((b * C + tab["fch"][t][node]) * Hc
                        + r + tab["fr"][t][node]) * Wc \
                    + c + tab["fc"][t][node]
                go_left = flat[addr] <= tab["thr"][t][node]
                node = torch.where(inner, torch.where(
                    go_left, left, tab["right"][t][node]), node)
                read[addr[inner]] = True
                evals += inner.sum()
            hs = hs + tab["pred"][t][node]
            alive = hs >= self.theta[t]
            b, r, c, hs = b[alive], r[alive], c[alive], hs[alive]
        stats = {"canvas_values_read": int(read.sum()),
                 "node_evals": int(evals),
                 "stages_entered": entered,
                 "model_values": sum(self.stage_nodes[:entered]) + entered}
        return b, r, c, hs, n_weak, stats

    # -- 3. extraction and 4. NMS ------------------------------------------
    def __call__(self, frames: torch.Tensor) -> Tuple[Dict[str, np.ndarray],
                                                      dict]:
        """The five outputs of a batch as numpy arrays, and the walk's
        counts with ``n_weak`` and the survivors summed over the batch."""
        B = frames.shape[0]
        b, r, c, hs, n_weak, stats = self.walk(self.canvas(frames))
        b, r, c, hs = (x.cpu().numpy() for x in (b, r, c, hs))
        gu, gv = self.valid.shape
        k = min(self.k, gu * gv)
        m, n = self.window
        rects = np.zeros((B, k, 4), np.float32)
        scores = np.full((B, k), -np.inf, np.float32)
        keep = np.zeros((B, k), bool)
        count = np.zeros(B, np.int32)
        for i in range(B):
            sel = b == i
            ri, ci, si = r[sel], c[sel], hs[sel]
            count[i] = len(si) if len(si) <= k else -1
            order = np.argsort(-si, kind="stable")[:k]
            ri, ci, si = ri[order], ci[order], si[order]
            lid = self.level_id[ri, ci]
            x1 = (ci - self.offsets[lid, 1]).astype(np.float32)
            y1 = (ri - self.offsets[lid, 0]).astype(np.float32)
            box = np.stack([x1, y1, x1 + np.float32(n), y1 + np.float32(m)],
                           axis=-1) * self.inv_scales[lid][:, None]
            got = len(si)
            rects[i, :got], scores[i, :got] = box, si
            keep[i, :got] = _nms(box, self.nms_iou) \
                if self.nms_iou is not None else True
        stats["n_weak"] = int(n_weak.sum())
        stats["survivors"] = int(len(hs))
        out = dict(rects=rects, scores=scores, keep=keep, count=count,
                   n_weak=n_weak.cpu().numpy().astype(np.int32))
        return out, stats


def _depth(left: np.ndarray, right: np.ndarray) -> int:
    """The longest root-to-leaf path of any stage's tree."""
    best = 0
    for lt, rt in zip(left, right):
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            if lt[node] < 0:
                best = max(best, d)
            else:
                stack += [(int(lt[node]), d + 1), (int(rt[node]), d + 1)]
    return best


def _nms(box: np.ndarray, thr: float) -> np.ndarray:
    """Greedy NMS of boxes already in score order: each box not yet
    dropped is kept and drops the later boxes whose IoU with it exceeds
    ``thr``."""
    n = len(box)
    area = np.maximum(box[:, 2] - box[:, 0], np.float32(0)) \
        * np.maximum(box[:, 3] - box[:, 1], np.float32(0))
    alive = np.ones(n, bool)
    keep = np.zeros(n, bool)
    thr = np.float32(thr)
    for i in range(n):
        if not alive[i]:
            continue
        keep[i] = True
        x1 = np.maximum(box[i, 0], box[:, 0])
        y1 = np.maximum(box[i, 1], box[:, 1])
        x2 = np.minimum(box[i, 2], box[:, 2])
        y2 = np.minimum(box[i, 3], box[:, 3])
        inter = np.maximum(x2 - x1, np.float32(0)) \
            * np.maximum(y2 - y1, np.float32(0))
        union = area[i] + area - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0, inter / union, np.float32(0))
        alive &= ~(iou > thr)
    return keep
