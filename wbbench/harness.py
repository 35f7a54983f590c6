"""One run of one cell: set-up, the measured window, the check, the
result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``wbbench/configs/<name>.json``: the model file, frame
size, frames a chip, k, NMS, chips) and a traffic mix
(``wbbench/workloads/<traffic>.json``: the frame kind, its parameters and
the pool size).  Per-layer metrics are ``wbbench/metrics/<name>.py``,
each with ``read(ctx)``: ``ctx`` holds the traced ``calls``, the reduced
``trace`` (:func:`wbbench.trace.reduce_trace`), the cell's ``chips``, its
``config`` and ``runs``, the reference's statistics of each traced call's
frames, in order (the walk's counts: canvas values read, nodes
evaluated, stages entered, survivors, and the cell's shapes).  Nothing
here names a cell, a configuration or a metric: a new one is new files
and new entries.

The loop is closed, with one client: each call takes a batch of frames
already on the card(s), runs the detector (``make_batched_detector_boxes``
of the program, over a mesh of the cell's chips when it has more than
one) and copies its five outputs to the host; the next call starts when
they are there.  Every call is timed from its start to its outputs on the
host.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import trace
from .reference.detector import OUTPUTS, ReferenceDetector
from .traffic import make_pool

__all__ = ["load_cell", "run_cell", "window_stats", "compare",
           "FORBIDDEN", "forbidden_modules"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "waldboost_tpu")
WINDOW_SPAN = "bench.window"


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def load_cell(name: str, bench: Optional[dict] = None,
              root: str = ROOT) -> dict:
    """The cell's entry, its configuration and its traffic, and the
    metrics it reports, from ``bench`` (``BENCHMARK.json`` under
    ``root`` when None) and the files it names under ``root``."""
    if bench is None:
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            bench = json.load(fh)
    cell = _named(bench["workloads"], name, "workload")
    cfg_entry = _named(bench["configs"], cell["config"], "configuration")
    with open(os.path.join(root, cfg_entry["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "wbbench", "workloads",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": cfg, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def load_metric(name: str, root: str = ROOT) -> Callable[[dict], object]:
    """The ``read`` function of ``wbbench/metrics/<name>.py`` under
    ``root``, else beside this file."""
    path = os.path.join(root, "wbbench", "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "wbbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window_stats(times: List[float], window_s: float,
                 pixels_per_call: int) -> Dict[str, float]:
    """End-to-end numbers of a window: the rate over all its pixels and
    all its time, and the median and 95th percentile (linear, numpy's
    default) over all its calls."""
    t = np.asarray(times, np.float64)
    return {"mpix_s": len(t) * pixels_per_call / window_s / 1e6,
            "batch_p50_ms": float(np.percentile(t, 50)) * 1e3,
            "batch_p95_ms": float(np.percentile(t, 95)) * 1e3}


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> int:
    """Values of the five outputs that differ bitwise (all of an output
    whose shape differs)."""
    bad = 0
    for key in OUTPUTS:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        if a.shape != b.shape or a.dtype != b.dtype:
            bad += max(a.size, b.size)
            continue
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        bad += int((a != b).sum())
    return bad


class Buffers:
    """Host buffers of one call's five outputs (pinned on a card)."""

    def __init__(self, shapes, pin: bool):
        self.arrays = {k: torch.empty(s, dtype=dt, pin_memory=pin)
                       for k, (s, dt) in shapes.items()}

    def fill(self, outs, per: int) -> None:
        for key, out in zip(OUTPUTS, outs):
            dst = self.arrays[key]
            if isinstance(out, (list, tuple)):
                for i, shard in enumerate(out):
                    dst[i * per:(i + 1) * per].copy_(shard, non_blocking=True)
            else:
                dst.copy_(out, non_blocking=True)

    def numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.numpy().copy() for k, v in self.arrays.items()}


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return " | ".join(out.stdout.strip().splitlines()) or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def host_cpu() -> Optional[List[int]]:
    """The host's (steal, total) CPU time in clock ticks since boot, from
    ``/proc/stat``; None where there is none."""
    try:
        with open("/proc/stat") as fh:
            ticks = [int(v) for v in fh.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return [ticks[7] if len(ticks) > 7 else 0, sum(ticks)]


def drift(times: List[float], parts: int = 6) -> List[float]:
    """Mean milliseconds a call in each of ``parts`` equal runs of calls:
    how the host's speed moved through the window."""
    n = len(times) // parts
    if not n:
        return []
    return [1e3 * sum(times[i * n:(i + 1) * n]) / n for i in range(parts)]


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             devices, t_start: float, bench: Optional[dict] = None,
             root: str = ROOT, wrap: Optional[Callable] = None,
             log=print) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``devices``: one torch device a chip (the cell's chips of them);
    ``t_start``: the process's start on ``time.perf_counter``'s clock;
    ``wrap``: a function of the detector that returns the callable the
    window drives (tests plant faults with it)."""
    import waldboost_tpu_torch as wt
    from waldboost_tpu_torch.parallel.detect import \
        make_batched_detector_boxes
    from waldboost_tpu_torch.parallel.mesh import make_mesh

    spec = load_cell(name, bench, root)
    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    chips = int(cell["chips"])
    devices = [torch.device(d) for d in devices][:chips]
    if len(devices) < chips:
        raise RuntimeError(f"{name} needs {chips} devices")
    per = int(cfg["frames_per_chip"])
    batch = per * chips
    hw = tuple(cfg["frame_hw"])
    model_path = os.path.join(root, cfg["model"])

    # -- set-up ------------------------------------------------------------
    model = wt.load(model_path, device=devices[0])
    if list(model.shape) != list(cfg["window"]):
        raise ValueError(f"{cfg['model']}: window {model.shape}, the "
                         f"configuration states {cfg['window']}")
    kw = dict(k=int(cfg["k"]), nms_iou=cfg["nms_iou"])
    if chips == 1:
        det, _ = make_batched_detector_boxes(model, hw, device=devices[0],
                                             **kw)
    else:
        det, _ = make_batched_detector_boxes(
            model, hw, mesh=make_mesh(devices=devices), **kw)
    fn = det if wrap is None else wrap(det)
    n_frames = int(traffic["pool_frames"])
    if n_frames % batch:
        raise ValueError(f"pool of {n_frames} frames, calls of {batch}")
    frames = make_pool(traffic, hw, n_frames, seed, devices[0], batch)
    pool = []
    for j in range(n_frames // batch):
        x = frames[j * batch:(j + 1) * batch]
        pool.append(x if chips == 1 else
                    [x[i * per:(i + 1) * per].to(d, copy=True)
                     for i, d in enumerate(devices)])
    warm = fn(pool[0])
    k_slots = warm[1][0].shape[1] if chips > 1 else warm[1].shape[1]
    shapes = {"rects": ((batch, k_slots, 4), torch.float32),
              "scores": ((batch, k_slots), torch.float32),
              "keep": ((batch, k_slots), torch.bool),
              "count": ((batch,), torch.int32),
              "n_weak": ((batch,), torch.int32)}
    pin = devices[0].type == "cuda"
    first = [Buffers(shapes, pin) for _ in pool]
    last = [Buffers(shapes, pin) for _ in pool]
    for j in range(min(2, len(pool))):
        last[j].fill(fn(pool[j]), per)
    _sync(devices)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    gc.collect()
    seen = [0] * len(pool)

    def call(j):
        t0 = time.perf_counter()
        with trace.span("bench.call"):
            outs = fn(pool[j])
            with trace.span("bench.copy"):
                (last if seen[j] else first)[j].fill(outs, per)
                _sync(devices)
        seen[j] += 1
        return time.perf_counter() - t0

    setup_s = time.perf_counter() - t_start

    # -- the window ----------------------------------------------------------
    times: List[float] = []
    order: List[int] = []
    tr = None
    if traced:
        n_calls = int(traffic.get("trace_calls", 2 * len(pool)))
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if pin else [])
        with profile(activities=acts) as prof:
            with trace.span(WINDOW_SPAN, force=True):
                for i in range(n_calls):
                    order.append(i % len(pool))
                    times.append(call(order[-1]))
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = trace.parse(path, WINDOW_SPAN,
                             [d.index or 0 for d in devices])
        finally:
            os.remove(path)
        window_s = tr["window_s"]
    else:
        cpu0 = host_cpu()
        start = time.perf_counter()
        while True:
            order.append(len(order) % len(pool))
            times.append(call(order[-1]))
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
        cpu1 = host_cpu()
        steal = (cpu1[0] - cpu0[0]) / (cpu1[1] - cpu0[1]) \
            if cpu0 and cpu1 and cpu1[1] > cpu0[1] else "not read"
        log(f"host: ms a call by sixths of the window {drift(times)!r}; "
            f"steal {steal!r} of the host's CPU time")
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)

    # -- the check -----------------------------------------------------------
    del det, fn, warm, model
    gc.collect()
    if pin:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ReferenceDetector(model_path, hw, int(cfg["k"]), cfg["nms_iou"],
                            devices[0])
    bad_entries, mismatched, checked = set(), 0, 0
    stats = []
    for j, x in enumerate(pool):
        if not seen[j]:
            stats.append(None)
            continue
        x = torch.cat([s.to(devices[0]) for s in x]) if chips > 1 else x
        outs, st = [], None
        for i in range(0, batch, per):
            o, s = ref(x[i:i + per])
            outs.append(o)
            st = s if st is None else {key: st[key] + s[key] if key in (
                "canvas_values_read", "node_evals", "n_weak", "survivors")
                else max(st[key], s[key]) for key in st}
        want = {key: np.concatenate([o[key] for o in outs]) for key in
                OUTPUTS}
        st.update(frames=batch, k_slots=want["scores"].shape[1],
                  channels=ref.n_channels,
                  level_pixels=sum(p.level.height * p.level.width
                                   for p in ref.packing.levels),
                  canvas_values=ref.n_channels * sum(
                      p.level.out_height * p.level.out_width
                      for p in ref.packing.levels))
        stats.append(st)
        for bufs in (first[j], last[j]) if seen[j] > 1 else (first[j],):
            bad = compare(bufs.numpy(), want)
            checked += 1
            mismatched += bad
            if bad:
                bad_entries.add(j)
    log(f"reference: {sum(1 for n in seen if n)} calls in "
        f"{time.perf_counter() - t_ref!r} s")
    failed = sum(1 for j in order if j in bad_entries)
    checks = {"mismatched_values": {"value": mismatched, "limit": 0,
                                    "must_be": "at_most"},
              "outputs_checked": {"value": checked, "limit": 1,
                                  "must_be": "at_least"}}
    correct = mismatched <= 0 and checked >= 1

    # -- metrics -----------------------------------------------------------
    plim = power_limit() if pin else "no card"
    metrics = {}
    if traced:
        ctx = {"calls": len(order), "trace": tr, "chips": chips,
               "config": cfg, "runs": [stats[j] for j in order]}
        for m in spec["per_layer"]:
            v = load_metric(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
                log(f"{m['name']} {v!r} {m['unit']} (card: {plim})")
    else:
        stats_e2e = window_stats(times, window_s, batch * hw[0] * hw[1])
        stats_e2e["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            if m["name"] in stats_e2e:
                metrics[m["name"]] = {"value": stats_e2e[m["name"]],
                                      "unit": m["unit"]}
    log(f"{name}: seed {seed}, {len(order)} calls of {batch} frames in "
        f"{window_s!r} s, set-up {setup_s!r} s, peak {peak} bytes, "
        f"card: {plim}")
    result = {"correct": bool(correct), "attempted": len(order),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if pin else devices[0].type,
                         "kind": torch.cuda.get_device_name(devices[0])
                         if pin else devices[0].type,
                         "count": chips, "memory_peak_bytes": int(peak)}}
    if traced:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr["device_ops"][:10]],
            "idle_gaps": [[n, s] for n, s in tr["idle_gaps"][:10]]}
    result["checks"] = checks
    return result
