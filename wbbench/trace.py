"""Reduce a torch.profiler Chrome trace to the numbers the per-layer
metrics read.

Each device event (kernel, memcpy, memset) is given to the innermost host
span (``wb.*`` from the program, ``bench.*`` from the harness) that holds
its launch, matched by CUDA correlation id.  A device is busy where some
device event of it runs inside the window; ``busy_s`` is the mean over
the devices the run used.  An idle gap of a device is charged to the
innermost host span running at its midpoint.
"""

from __future__ import annotations

import json
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

__all__ = ["parse", "reduce_trace", "union_length", "span"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str, force: bool = False):
    """A profiler span while a torch profiler runs (or with ``force``),
    else nothing."""
    if force or torch._C._autograd._profiler_enabled():
        return record_function(name)
    return nullcontext()


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length covered by a set of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def _merge(intervals):
    out: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _innermost(spans, t: float) -> Optional[str]:
    """The shortest span of ``spans`` (sorted by start) holding ``t``."""
    best = None
    for s0, s1, name in spans:
        if s0 > t:
            break
        if s1 >= t and (best is None or s1 - s0 < best[1] - best[0]):
            best = (s0, s1, name)
    return None if best is None else best[2]


def reduce_trace(trace: dict, window: str, devices: Sequence[int]) -> dict:
    """``window`` names the user annotation around the traced calls and
    ``devices`` the CUDA device indices the run used.  Returns the window
    and busy seconds, the idle share, per span name its host and device
    seconds and count, the device operations by total seconds, and the
    idle seconds by the host span that was running."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in ev if e.get("cat") == "user_annotation"
           and e["name"] == window]
    if len(win) != 1:
        raise ValueError(f"trace has no single {window!r} span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                    if e.get("cat") == "user_annotation"
                    and e["name"] != window
                    and e["name"].startswith(("wb.", "bench."))
                    and w0 <= e["ts"] <= w1), key=lambda s: s[0])
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    layers: Dict[str, dict] = {}
    for s0, s1, name in spans:
        d = layers.setdefault(name, {"host_s": 0.0, "device_s": 0.0,
                                     "count": 0})
        d["host_s"] += (s1 - s0) / 1e6
        d["count"] += 1
    per_dev: Dict[int, list] = {int(d): [] for d in devices}
    ops: Dict[str, float] = {}
    n_dev = 0
    for e in ev:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0, t1 = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t1 <= t0:
            continue
        n_dev += 1
        dev = int(e.get("args", {}).get("device", devices[0]))
        per_dev.setdefault(dev, []).append((t0, t1))
        ops[e["name"]] = ops.get(e["name"], 0.0) + (t1 - t0) / 1e6
        lt = launch.get(e.get("args", {}).get("correlation"))
        owner = _innermost(spans, lt) if lt is not None else None
        d = layers.setdefault(owner or "other",
                              {"host_s": 0.0, "device_s": 0.0, "count": 0})
        d["device_s"] += (t1 - t0) / 1e6
    window_s = (w1 - w0) / 1e6
    busy = [union_length(per_dev.get(int(d), [])) / 1e6 for d in devices]
    gaps: Dict[str, float] = {}
    for d in devices:
        merged = _merge(per_dev.get(int(d), []))
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                name = _innermost(spans, (g0 + g1) / 2) or "none"
                gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6 \
                    / len(devices)
    busy_s = sum(busy) / len(busy)
    return {"window_s": window_s, "busy_s": busy_s,
            "idle_share": 1.0 - busy_s / window_s if window_s > 0 else None,
            "n_device_events": n_dev, "layers": layers,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1]),
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])}


def parse(path: str, window: str, devices: Sequence[int]) -> dict:
    with open(path) as fh:
        return reduce_trace(json.load(fh), window, devices)
