#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths on VGA frames (640x480, shrink 2, n_per_oct 8,
smooth 1, grad_hist) with the committed models and its BASELINE config-5
path on 3840x2160 frames (FPGA integer channels grad_hist_4_u1+grad_mag_u1,
C = 5, shrink 2, n_per_oct 4, smooth 0 and 1, the committed
models/fpga_4k_*synth_64.pb), and checks and times its six CUDA kernels
(planes B1, grad_hist B2, cascade B3, cascade_response B4, fpga B5,
cascade_generic B6):

 1. prints torch/CUDA versions and the card's name and power limit;
 2. builds the kernels from waldboost_tpu_torch/csrc (one nvcc per source,
    all at once) and prints ptxas's register / shared-memory / spill
    report;
 3. runs each kernel at the VGA batch-8 shapes against its plain-torch
    version on the card, bitwise (tolerance 0), mismatches printed per
    phase: B1, B2, B3 on a noise batch; B4 with flagship_synth_64 and
    flagship_hard_256, n_stages_cap None and 12, on the noise and the
    golden-scene canvas; B6 on the padded tables of flagship_synth_64
    (complete heaps), flagship_hard_256, and a seeded 40-stage model of
    depth-5 trees (bucket 64: 24 inactive stages, general routing), on
    both canvases; hs is compared at every window origin;
 4. serving path (slice 1): make_batched_detector_boxes(k=1024,
    nms_iou=0.5) on the 3 golden scene frames with every launch counter
    set to 0 first: survivor counts, kept boxes and scores equal the
    committed JAX outputs (tests/data/torch_port_vga_golden.npz) bitwise,
    and B1-B3 launched;
 5. Model-API path: counters set to 0, then on the golden frames
    Model.detect, detect_topk(k=1024, nms_iou=0.5) and scan_packed_batch
    of the three committed models, wt.detect over all three
    (response_scale 1, 0.5, 2), make_batched_detector (all stages and
    n_stages_cap=12) and make_multi_detector_boxes; counters read, then
    every result checked against the committed JAX outputs
    (tests/data/torch_port_model_golden.npz) bitwise; all five kernels
    must have launched;
 5b. at the config-5 batch-8 shapes (4K noise, halo-0 plan, C = 5), each
    kernel of that path against its plain version, bitwise: B1, B5 (the
    composite kind, smooth 0 and 1), B3, and B4 for both FPGA models with
    n_stages_cap None and the golden's prefix length; B5 also for each
    single kind and the reversed composite on VGA planes; then the
    config-5 path: counters
    set to 0, both FPGA models and their prefixes (model_from_stages)
    through make_batched_detector_boxes(k=1024, nms_iou=0.5),
    Model.detect and make_batched_detector(n_stages_cap) on the seeded 4K
    noise frames of tests/data/torch_port_fpga_golden.npz; counters read
    (B1, B5, B3, B4 must have launched), then counts, n_weak, alive counts,
    kept boxes and scores checked against that file bitwise;
 6. times each kernel against its plain version (CUDA events, in turns),
    each layer of the serving path, the serving path end to end (60
    batches of 8 per workload, MP/s, p50/p80), Model.detect and the
    three-model wt.detect (ms/frame, p50 of 30 frames) and
    make_batched_detector (MP/s at batch 8, 30 batches); at config 5: B5
    and B3 (C = 5) against their plain versions and bounds, and the
    serving path end to end (k=128, NMS 0.5, smooth 0 and 1, MP/s with
    p50/p80 over 20 batches of 8) and the peak device memory; probes the
    host;
 7. traces 10 batches of each serving workload with torch.profiler and
    prints the device idle share and, per layer span (wb.*), host and
    device time, and 3 batches of each config-5 workload likewise;
 8. prints the per-kernel JSON summary (launches from the Model-API path,
    B5's from the config-5 path,
    max_abs_err, ms, plain_ms, bound_ms from this run's shapes), then the
    final ok line.

Any failed phase raises and the script exits nonzero without the ok line.
It never falls back to the CPU.

Usage: python chip_smoke.py [--trace-dir DIR]   (DIR keeps the traces)
"""

import argparse

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
VGA = (480, 640)
BATCH = 8
MODEL_NAMES = ("flagship_synth_64", "flagship_hard_64", "flagship_hard_256")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_vga_golden.npz")
MODEL_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_port_model_golden.npz")
FPGA_GOLDEN = os.path.join(ROOT, "tests", "data",
                           "torch_port_fpga_golden.npz")
#: the committed BASELINE config-5 models (smooth 0, smooth 1)
FPGA_MODELS = ("fpga_4k_synth_64", "fpga_4k_smooth_synth_64")

# kernel name -> (module of its launch counter, counter attribute, CUDA
# source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "planes": ("waldboost_tpu_torch.ops.planes", "planes_launches",
               "waldboost_tpu_torch/csrc/planes.cu",
               "waldboost_tpu/ops/plane_pallas.py:339 and :483"),
    "grad_hist": ("waldboost_tpu_torch.ops.channels", "grad_hist_launches",
                  "waldboost_tpu_torch/csrc/grad_hist.cu",
                  "waldboost_tpu/ops/channels_pallas.py:405"),
    "cascade": ("waldboost_tpu_torch.ops.cascade_static", "cascade_launches",
                "waldboost_tpu_torch/csrc/cascade.cu",
                "waldboost_tpu/ops/cascade_static.py:764"),
    "cascade_response": ("waldboost_tpu_torch.ops.cascade_static",
                         "cascade_response_launches",
                         "waldboost_tpu_torch/csrc/cascade.cu",
                         "waldboost_tpu/ops/cascade_static.py:611"),
    "fpga": ("waldboost_tpu_torch.ops.fpga", "fpga_launches",
             "waldboost_tpu_torch/csrc/fpga.cu",
             "waldboost_tpu/ops/channels_pallas.py:684"),
    "cascade_generic": ("waldboost_tpu_torch.ops.cascade",
                        "cascade_generic_launches",
                        "waldboost_tpu_torch/csrc/cascade.cu",
                        "waldboost_tpu/ops/cascade_pallas.py:182"),
}

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (and the
#: integer work counted with it) and float64 operations/s outside the
#: tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
F64_OPS_S = 34e12


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def random_deep_stage(rng, window, n_channels, depth=5):
    """A random tree exactly ``depth`` deep (its leftmost path) with
    shallower leaves elsewhere, numbered in preorder (children above their
    parent), as a stage dict (numpy only)."""
    m, n = window
    feature, left, right = [], [], []

    def node(d, full):
        k = len(left)
        feature.append([0, 0, 0])
        left.append(-1)
        right.append(-1)
        if d < depth and (full or rng.rand() < 0.6):
            feature[k] = [rng.randint(m), rng.randint(n),
                          rng.randint(n_channels)]
            left[k] = node(d + 1, full)
            right[k] = node(d + 1, False)
        return k

    node(0, True)
    k = len(left)
    return dict(feature=np.array(feature), threshold=rng.randn(k).astype("f"),
                left=np.array(left), right=np.array(right),
                prediction=rng.randn(k).astype("f"))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def max_abs_err(got, want):
    """Largest |got - want| over tensors of one shape; equal entries
    (infinities included) count 0, an infinity against a finite value
    counts inf."""
    import torch
    if got.shape != want.shape:
        return float("inf")
    got, want = got.double(), want.double()
    diff = torch.where(got == want, torch.zeros_like(got),
                       (got - want).abs().nan_to_num(nan=float("inf")))
    return float(diff.max()) if diff.numel() else 0.0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, f32_ops=0.0, f64_ops=0.0):
    """(ms, what bounds it): the least time of a call that moves
    ``n_bytes`` and does the given operations."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max(f32_ops / F32_OPS_S, f64_ops / F64_OPS_S)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def host_probe():
    """Host-side costs that bound a launch-heavy path: one tiny kernel
    launch, a launch plus synchronize round trip, one layer span with no
    profiler running (us each), and a fixed pure-Python loop (ms)."""
    import torch
    from waldboost_tpu_torch.parallel.detect import span
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    launch = (time.perf_counter() - t) / 2000 * 1e6
    t = time.perf_counter()
    for _ in range(200):
        x.add_(1)
        torch.cuda.synchronize()
    sync = (time.perf_counter() - t) / 200 * 1e6
    t = time.perf_counter()
    for _ in range(2000):
        with span("probe"):
            pass
    span_us = (time.perf_counter() - t) / 2000 * 1e6
    t = time.perf_counter()
    sum(i * i for i in range(200000))
    loop = (time.perf_counter() - t) * 1e3
    return {"host_launch_us": launch, "host_launch_sync_us": sync,
            "host_span_us": span_us, "host_python_loop_ms": loop}


def trace_breakdown(trace, window):
    """Device idle share and per-span time of a Chrome trace.

    ``window`` names the user annotation that encloses the traced batches.
    Each device event (kernel, memcpy, memset) is given to the innermost
    ``wb.*`` span that holds its launch on the host (matched by CUDA
    correlation id); device busy time is the union of device intervals
    inside the window.
    """
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in ev if e.get("cat") == "user_annotation"
           and e["name"] == window]
    require(len(win) == 1, f"trace has no single {window!r} span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("wb.")), key=lambda s: s[0])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                              "gpu_memset")]
    per = {}
    for s0, s1, name in spans:
        per.setdefault(name, {"host_ms": 0.0, "device_ms": 0.0})
        per[name]["host_ms"] += (s1 - s0) / 1e3
    per.setdefault("other", {"host_ms": 0.0, "device_ms": 0.0})
    intervals = []
    for e in dev:
        t0, t1 = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t1 > t0:
            intervals.append((t0, t1))
        lt = launch_ts.get(e.get("args", {}).get("correlation"))
        owner = "other"
        if lt is not None:
            inner = [s for s in spans if s[0] <= lt <= s[1]]
            if inner:
                owner = min(inner, key=lambda s: s[1] - s[0])[2]
        per[owner]["device_ms"] += e["dur"] / 1e3
    busy, end = 0.0, w0
    for t0, t1 in sorted(intervals):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return {"window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (w1 - w0),
            "n_device_events": len(dev), "layers": per}


def sorted_rows(*cols):
    """(N, k) float32 rows of the given columns in lexicographic order."""
    cols = [np.asarray(c, np.float32) for c in cols]
    rows = np.concatenate([c[:, None] if c.ndim == 1 else c for c in cols],
                          axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def box_rows(boxes, *fields):
    return sorted_rows(boxes.get(), *(boxes.get_field(f) for f in fields))


def golden_split(g, key):
    return np.split(g[key + "_rows"], np.cumsum(g[key + "_counts"])[:-1])


def fpga_frames(g):
    """``(hw, frames)`` of the config-5 golden: its seeded uint8 noise."""
    hw = tuple(int(v) for v in g["hw"])
    frames = np.random.RandomState(int(g["seed"])).randint(
        0, 256, (int(g["n_frames"]),) + hw).astype(np.uint8)
    return hw, frames


def fpga_path(wt, dev, g, models):
    """Every config-5 call the golden ``g`` records, on ``dev``: per model
    name the full cascade's and its prefix's make_batched_detector_boxes
    outputs and Model.detect rows and counters, and make_batched_detector
    (n_stages_cap) alive counts and n_weak, as numpy."""
    import torch
    hw, frames = fpga_frames(g)
    images = torch.from_numpy(frames).to(dev)
    k, iou = int(g["k"]), float(g["nms_iou"])

    def detect_all(model):
        out = []
        for img in frames:
            model.reset()
            boxes = model.detect(img)
            out.append((box_rows(boxes, "scores"), model.n_weak, model.n_loc))
        return out

    res = {}
    for name, model in models.items():
        P = int(g[name + "_prefix_stages"])
        prefix = wt.model_from_stages(model.shape, model.channel_opts,
                                      model.stages[:P], model.theta[:P],
                                      device=dev)
        full, _ = wt.make_batched_detector_boxes(model, hw, k=k, nms_iou=iou,
                                                 device=dev)
        pre, _ = wt.make_batched_detector_boxes(prefix, hw, k=k, nms_iou=iou,
                                                device=dev)
        cap, _ = wt.make_batched_detector(model, hw, n_stages_cap=P,
                                          device=dev)
        _, alive, cap_nw = cap(images)
        res[name] = dict(
            full=[a.cpu().numpy() for a in full(images)],
            full_detect=detect_all(model),
            prefix=[a.cpu().numpy() for a in pre(images)],
            prefix_detect=detect_all(prefix),
            cap=(alive.sum(dim=(1, 2)).cpu().numpy(), cap_nw.cpu().numpy()))
    return res


def check_fpga_path(g, res):
    """Hold :func:`fpga_path`'s results to the golden, bitwise.  The boxes
    NMS keeps are held to the JAX package's host NMS of the same survivors
    (``kept_host``); whether JAX's device NMS kept the same is printed."""
    for name, r in res.items():
        _, _, _, count, n_weak = r["full"]
        require(np.array_equal(count, g[name + "_full_count"])
                and np.array_equal(n_weak, g[name + "_full_n_weak"]),
                f"{name}: full-cascade survivors or n_weak differ from JAX")
        for i, (rows, nw, nloc) in enumerate(r["full_detect"]):
            require((len(rows), nw, nloc) == (
                g[name + "_full_detect_counts"][i],
                g[name + "_full_detect_n_weak"][i],
                g[name + "_full_detect_n_loc"][i]),
                f"{name} frame {i}: full Model.detect differs from JAX")
        rects, scores, valid, count, n_weak = r["prefix"]
        require(np.array_equal(count, g[name + "_prefix_count"])
                and np.array_equal(n_weak, g[name + "_prefix_n_weak"]),
                f"{name}: prefix survivors or n_weak differ from JAX")
        agree = []
        for b, (ref, dev_ref) in enumerate(zip(
                golden_split(g, name + "_prefix_kept_host"),
                golden_split(g, name + "_prefix_kept"))):
            got = sorted_rows(rects[b][valid[b]], scores[b][valid[b]])
            require(np.array_equal(got, sorted_rows(ref)),
                    f"{name} frame {b}: prefix kept boxes differ from JAX")
            agree.append(np.array_equal(got, sorted_rows(dev_ref)))
        for i, (rows, det_ref) in enumerate(zip(
                r["prefix_detect"], golden_split(g, name + "_prefix_detect"))):
            require(np.array_equal(rows[0], sorted_rows(det_ref))
                    and rows[1:] == (g[name + "_prefix_detect_n_weak"][i],
                                     g[name + "_prefix_detect_n_loc"][i]),
                    f"{name} frame {i}: prefix Model.detect differs from JAX")
        alive, cap_nw = r["cap"]
        require(np.array_equal(alive, g[name + "_cap_alive"])
                and np.array_equal(cap_nw, g[name + "_cap_n_weak"]),
                f"{name}: make_batched_detector(n_stages_cap) differs")
        print(f"{name}: full cascade survivors {r['full'][3].tolist()}, "
              f"Model.detect {[len(d[0]) for d in r['full_detect']]}; "
              f"{int(g[name + '_prefix_stages'])}-stage prefix survivors "
              f"{count.tolist()}, kept {valid.sum(1).tolist()} (JAX device "
              f"NMS agrees: {agree}), Model.detect "
              f"{[len(d[0]) for d in r['prefix_detect']]}, n_stages_cap alive "
              f"{alive.tolist()}: bitwise equal to JAX")


def main():
    import importlib

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="keep the profiler traces (Chrome JSON) here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: the smoke "
                           "test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import waldboost_tpu_torch as wt
    from waldboost_tpu_torch import _build, packing
    from waldboost_tpu_torch.canvas import channel_canvas
    from waldboost_tpu_torch.channels import resolve_channel_function
    from waldboost_tpu_torch.ops import cascade as gen_mod
    from waldboost_tpu_torch.ops import cascade_static as casc_mod
    from waldboost_tpu_torch.ops import channels as chan_mod
    from waldboost_tpu_torch.ops import fpga as fpga_mod
    from waldboost_tpu_torch.ops import planes as plane_mod
    from waldboost_tpu_torch.ops.nms import extract_detections
    counters = {name: (importlib.import_module(mod), attr)
                for name, (mod, attr, _, _) in KERNELS.items()}

    def zero_counters():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counters():
        return {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}

    dev = torch.device("cuda", torch.cuda.current_device())
    device_name = torch.cuda.get_device_name(dev)
    card = card_line()
    power_limit = card.split(",")[-1].strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 1: build ---------------------------------------------------
    t0 = time.time()
    sources = sorted({os.path.basename(src)[:-3]
                      for _, _, src, _ in KERNELS.values()})
    _build.build(sources)
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"[{name}] {line.strip()}")
    print(f"build: {time.time() - t0:.1f} s")

    models = {name: wt.load(os.path.join(ROOT, "models", name + ".pb"),
                            device=dev) for name in MODEL_NAMES}
    synth, hard256 = models["flagship_synth_64"], models["flagship_hard_256"]
    golden = np.load(GOLDEN)
    mgold = np.load(MODEL_GOLDEN)
    rng = np.random.RandomState(0)
    noise = [torch.from_numpy(rng.randint(0, 256, (BATCH,) + VGA)
                              .astype(np.uint8)).to(dev) for _ in range(4)]
    gframes = golden["frames"]
    require(gframes.shape == (3,) + VGA, "golden file must hold 3 VGA frames")
    require(np.array_equal(mgold["frames"], gframes),
            "the two golden files must hold the same frames")
    # the 3 golden scenes, then their horizontal and vertical flips
    scene_np = np.ascontiguousarray(np.concatenate(
        [gframes, gframes[:, :, ::-1], gframes[:, ::-1, :]])[:BATCH])
    require(scene_np.shape == (BATCH,) + VGA,
            "scene batch must hold BATCH frames")
    scene = torch.from_numpy(scene_np).to(dev)

    # -- phase 2: each kernel against its plain version at VGA batch 8 -----
    det, packed = wt.make_batched_detector_boxes(synth, VGA, k=1024,
                                                 nms_iou=0.5, device=dev)
    cstep, grid = det.canvas, det.grid
    print(f"plan: {len(packed.levels)} levels, canvas {packed.canvas_h}x"
          f"{packed.canvas_w}, {int(grid.valid.sum())} valid origins")
    octs = cstep.octaves(noise[0])
    planes = cstep.planes(octs)
    planes_ref = plane_mod.planes_plain(octs, cstep.plane_ops)
    canvas = cstep.channels(planes)
    canvas_ref = chan_mod.grad_hist_plain(planes, cstep.interior,
                                          cstep.smooth)
    casc = det.cascade(canvas)
    casc_ref = casc_mod.cascade_masked_plain(canvas, grid.valid,
                                             det.cascade_ops)
    scene_canvas = cstep(scene)
    torch.cuda.synchronize()
    errs = {}

    def check_phase(kernel, phase, got, want):
        torch.cuda.synchronize()
        bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        print(f"phase {phase}: {bad} mismatching elements of "
              f"{sum(g.numel() for g in got)} (max abs err {err})")
        require(bad == 0, f"{phase}: kernel differs from its plain version")

    check_phase("planes", "planes", [planes], [planes_ref])
    check_phase("grad_hist", "grad_hist", [canvas], [canvas_ref])
    check_phase("cascade", "cascade", casc, casc_ref)
    masked, n_weak, count = casc
    print(f"noise batch: survivors {count.tolist()}, n_weak "
          f"{n_weak.tolist()}")

    canvases = {"noise": canvas, "scene": scene_canvas}
    for mname in ("flagship_synth_64", "flagship_hard_256"):
        ops = models[mname]._operands(dev)
        for cap in (None, 12):
            for cname, cv in canvases.items():
                got = casc_mod.cascade_response(cv, grid.valid, ops, cap)
                want = casc_mod.cascade_response_plain(cv, grid.valid, ops,
                                                       cap)
                check_phase("cascade_response",
                            f"cascade_response {mname} cap={cap} {cname}",
                            got, want)
                print(f"  alive {got[1].sum(dim=(1, 2)).tolist()}, n_weak "
                      f"{got[2].tolist()}")
    drng = np.random.RandomState(1)
    deep_stages, deep_theta = [], []
    for t in range(40):
        s = random_deep_stage(drng, (12, 12), 4, depth=5)
        s["threshold"] = drng.uniform(0, 300, len(s["threshold"])) \
            .astype(np.float32)
        deep_stages.append(s)
        deep_theta.append(-0.6 - 0.1 * t if t % 2 else -np.inf)
    deep = wt.model_from_stages(synth.shape, synth.channel_opts, deep_stages,
                                deep_theta, device=dev)
    tables = {"flagship_synth_64": synth._get_cascade(),
              "flagship_hard_256": hard256._get_cascade(),
              "deep40": deep._get_cascade()}
    for tname, (ctab, meta) in tables.items():
        print(f"B6 tables {tname}: {ctab.n_stages} stages "
              f"({int(ctab.active.sum())} active), {ctab.n_nodes} nodes, "
              f"depth {meta.depth}, complete {meta.complete}")
        for cname, cv in canvases.items():
            got = gen_mod.cascade_response_grid(cv, ctab, (12, 12),
                                                grid.valid)
            want = gen_mod.cascade_response_grid_plain(cv, ctab, (12, 12),
                                                       grid.valid)
            check_phase("cascade_generic", f"cascade_generic {tname} {cname}",
                        got, want)
            print(f"  alive {got[1].sum(dim=(1, 2)).tolist()}, n_weak "
                  f"{got[2].tolist()}")
    require(tables["deep40"][0].n_stages == 64
            and not tables["deep40"][1].complete,
            "the deep model must take the padded general-tree tables")

    # -- phase 3: serving path (slice 1) on the golden frames --------------
    frames = torch.from_numpy(gframes).to(dev)
    zero_counters()
    rects, scores, valid, count, n_weak = det(frames)
    torch.cuda.synchronize()
    serving_launches = read_counters()
    print(f"serving path launches: {serving_launches}")
    require(all(serving_launches[k] > 0
                for k in ("planes", "grad_hist", "cascade")),
            "a kernel of the serving path was not launched")
    rects, scores = rects.cpu().numpy(), scores.cpu().numpy()
    valid, count = valid.cpu().numpy(), count.cpu().numpy()
    require(rects.shape == (len(gframes), 1024, 4)
            and np.isfinite(rects).all(), "bad box tensor")
    require(np.isfinite(scores[valid]).all(), "non-finite kept score")
    print(f"golden frames: survivors {count.tolist()} (JAX "
          f"{golden['raw_counts'].tolist()}), kept {valid.sum(1).tolist()} "
          f"(JAX {golden['kept_counts'].tolist()})")
    require(np.array_equal(count, golden["raw_counts"]),
            "survivor counts differ from the JAX golden")
    split = np.cumsum(golden["kept_counts"])[:-1]
    for b, (r_ref, s_ref) in enumerate(zip(
            np.split(golden["kept_rects"], split),
            np.split(golden["kept_scores"], split))):
        require(np.array_equal(sorted_rows(rects[b][valid[b]],
                                           scores[b][valid[b]]),
                               sorted_rows(r_ref, s_ref)),
                f"frame {b}: kept boxes/scores differ from the JAX golden")
    print("serving path: boxes and scores bitwise equal to JAX")

    # -- phase 4: the Model-API path on the golden frames ------------------
    scales = [float(s) for s in mgold["response_scale"]]
    k_top, iou = int(mgold["topk_k"]), float(mgold["nms_iou"])
    fn_full, _ = wt.make_batched_detector(synth, VGA, device=dev)
    fn_cap, _ = wt.make_batched_detector(synth, VGA, n_stages_cap=12,
                                         device=dev)
    fn_multi, _ = wt.make_multi_detector_boxes(
        list(models.values()), VGA, k=2048, response_scale=scales,
        device=dev)
    zero_counters()
    api = {}
    for name, model in models.items():
        per = []
        for frame in gframes:
            model.reset()
            boxes = model.detect(frame)
            per.append((boxes, model.n_weak, model.n_loc,
                        model.detect_topk(frame, k=k_top, nms_iou=iou)))
        model.reset()
        scan = model.scan_packed_batch(gframes)
        api[name] = (per, scan, model.n_weak)
    multi = [wt.detect(frame, *models.values(), response_scale=scales)
             for frame in gframes]
    full = fn_full(frames)
    capped = fn_cap(frames)
    multi_b = fn_multi(frames)
    torch.cuda.synchronize()
    path_launches = read_counters()
    print(f"Model-API path launches: {path_launches}")
    require(all(v > 0 for k, v in path_launches.items() if k != "fpga"),
            "a kernel of the Model-API path was not launched")

    for name, (per, scan, scan_n_weak) in api.items():
        det_ref = golden_split(mgold, name + "_detect")
        topk_ref = golden_split(mgold, name + "_topk")
        scan_ref = golden_split(mgold, name + "_scan")
        for i, (boxes, nw, nloc, topk) in enumerate(per):
            require(np.array_equal(box_rows(boxes, "scores"),
                                   sorted_rows(det_ref[i])),
                    f"{name} frame {i}: Model.detect differs from JAX")
            require((nw, nloc) == (mgold[name + "_n_weak"][i],
                                   mgold[name + "_n_loc"][i]),
                    f"{name} frame {i}: n_weak/n_loc differ from JAX")
            require(np.array_equal(box_rows(topk, "scores"),
                                   sorted_rows(topk_ref[i])),
                    f"{name} frame {i}: detect_topk differs from JAX")
        _, hs, _, per_image = scan
        for i, (rs, cs) in enumerate(per_image):
            sc = hs[i][torch.as_tensor(rs, device=dev),
                       torch.as_tensor(cs, device=dev)].cpu().numpy()
            require(np.array_equal(np.stack([rs, cs, sc], 1)
                                   .astype(np.float32), scan_ref[i]),
                    f"{name} frame {i}: scan_packed_batch differs from JAX")
        require(scan_n_weak == mgold[name + "_scan_n_weak"].sum(),
                f"{name}: scan_packed_batch n_weak differs from JAX")
        print(f"{name}: detect {[len(p[0]) for p in per]}, topk "
              f"{[len(p[3]) for p in per]}, scan "
              f"{[len(p[0]) for p in per_image]} bitwise equal to JAX")
    multi_ref = golden_split(mgold, "multi")
    for i, boxes in enumerate(multi):
        require(np.array_equal(box_rows(boxes, "scores", "label"),
                               sorted_rows(multi_ref[i])),
                f"frame {i}: wt.detect differs from JAX")
    rects, scores, mvalid, label, mcount, _ = (a.cpu().numpy()
                                               for a in multi_b)
    for i in range(len(gframes)):
        ref = multi_ref[i]
        for kix in range(len(models)):
            require(mcount[i, kix] == (ref[:, 5] == kix).sum(),
                    f"frame {i} model {kix}: multi-detector count differs")
        sel = mvalid[i]
        require(np.array_equal(sorted_rows(rects[i][sel], scores[i][sel],
                                           label[i][sel]), sorted_rows(ref)),
                f"frame {i}: make_multi_detector_boxes differs from JAX")
    print(f"wt.detect and make_multi_detector_boxes: "
          f"{[len(b) for b in multi]} boxes bitwise equal to JAX")
    synth_scan = golden_split(mgold, "flagship_synth_64_scan")
    hs_f, alive_f, nw_f = full
    hs_c, alive_c, nw_c = capped
    for i, ref in enumerate(synth_scan):
        rs, cs = (torch.as_tensor(ref[:, j].astype(np.int64), device=dev)
                  for j in (0, 1))
        require(int(alive_f[i].sum()) == len(ref)
                and bool(alive_f[i][rs, cs].all())
                and np.array_equal(hs_f[i][rs, cs].cpu().numpy(), ref[:, 2]),
                f"frame {i}: make_batched_detector differs from JAX")
        require(bool(alive_c[i][rs, cs].all()),
                f"frame {i}: a survivor is dead after the 12-stage prefix")
    require(bool((nw_c <= nw_f).all()) and bool((alive_c | ~alive_f).all()),
            "the 12-stage prefix must do less work and keep more windows")
    prefix_ref = casc_mod.cascade_response_plain(
        cstep(frames), grid.valid, synth._operands(dev), 12)
    check_phase("cascade_response", "make_batched_detector prefix", capped,
                prefix_ref)
    print(f"make_batched_detector: survivors {alive_f.sum(dim=(1, 2)).tolist()}"
          f" of {alive_c.sum(dim=(1, 2)).tolist()} after 12 stages")

    # -- phase 4b: kernel B5 and the config-5 path (3840x2160, C = 5) -------
    fgold = np.load(FPGA_GOLDEN)
    hw4k = tuple(int(v) for v in fgold["hw"])
    require(hw4k == (2160, 3840), "the config-5 golden must be at 4K")
    fmodels = {name: wt.load(os.path.join(ROOT, "models", name + ".pb"),
                             device=dev) for name in FPGA_MODELS}
    gen = torch.Generator(device=dev).manual_seed(5)
    noise4k = [torch.randint(0, 256, (BATCH,) + hw4k, generator=gen,
                             dtype=torch.uint8, device=dev) for _ in range(2)]
    dets4k = {name: wt.make_batched_detector_boxes(
        mm, hw4k, k=128, nms_iou=0.5, device=dev)[0]
        for name, mm in fmodels.items()}
    c5 = {name: d.canvas for name, d in dets4k.items()}
    det5 = dets4k[FPGA_MODELS[0]]
    cs0 = c5[FPGA_MODELS[0]]
    octs4k = cs0.octaves(noise4k[0])
    planes4k = cs0.planes(octs4k)
    print(f"config-5 plan: {len(det5.packed.levels)} levels, canvas "
          f"{det5.packed.canvas_h}x{det5.packed.canvas_w}, halo "
          f"{det5.packed.halo}, {int(det5.grid.valid.sum())} valid origins")
    require(det5.packed.halo == 0, "the FPGA plan must have halo 0")
    # B1 with no reflect halo: edge levels sit at the canvas border
    check_phase("planes", f"planes 4K halo 0 batch {BATCH}", [planes4k],
                [plane_mod.planes_plain(octs4k, cs0.plane_ops)])
    canvas4k = {}
    for name, cs in c5.items():
        canvas4k[name] = cs.channels(planes4k)
        want = fpga_mod.fpga_channels_plain(planes4k, cs.ring, cs.interior,
                                            cs.cf.fused_kind, cs.smooth)
        check_phase("fpga", f"fpga {cs.cf.fused_kind} smooth={cs.smooth} "
                    f"4K batch {BATCH}", [canvas4k[name]], [want])
    del want
    vga4 = packing._packed_plan_cached(VGA[0], VGA[1], 2, 4, (12, 12),
                                       halo=0)
    for fkind in ("grad_hist_4_u1", "grad_mag_u1",
                  "grad_mag_u1+grad_hist_4_u1"):
        for sm in (0, 1):
            cs = channel_canvas(vga4, VGA, sm,
                                resolve_channel_function(fkind), dev)
            pv = cs.planes(cs.octaves(noise[0]))
            check_phase("fpga", f"fpga {fkind} smooth={sm} VGA batch {BATCH}",
                        [cs.channels(pv)],
                        [fpga_mod.fpga_channels_plain(pv, cs.ring, cs.interior,
                                                      fkind, sm)])
    casc5 = det5.cascade(canvas4k[FPGA_MODELS[0]])
    check_phase("cascade", f"cascade C=5 4K batch {BATCH}", casc5,
                casc_mod.cascade_masked_plain(canvas4k[FPGA_MODELS[0]],
                                              det5.grid.valid,
                                              det5.cascade_ops))
    print(f"config-5 noise batch: survivors {casc5[2].tolist()}, n_weak "
          f"{casc5[1].tolist()}")
    # B4 at C = 5 on each model's 4K canvas: all stages and the golden's
    # prefix length (the n_stages_cap of make_batched_detector)
    for name, mm in fmodels.items():
        ops5 = mm._operands(dev)
        for cap in (None, int(fgold[name + "_prefix_stages"])):
            got = casc_mod.cascade_response(canvas4k[name],
                                            dets4k[name].grid.valid, ops5, cap)
            want = casc_mod.cascade_response_plain(
                canvas4k[name], dets4k[name].grid.valid, ops5, cap)
            check_phase("cascade_response", f"cascade_response C=5 4K {name} "
                        f"cap={cap} batch {BATCH}", got, want)
            print(f"  alive {got[1].sum(dim=(1, 2)).tolist()}, n_weak "
                  f"{got[2].tolist()}")
    del got, want

    zero_counters()
    fres = fpga_path(wt, dev, fgold, fmodels)
    torch.cuda.synchronize()
    fpga_launches = read_counters()
    print(f"config-5 path launches: {fpga_launches}")
    require(all(fpga_launches[k] > 0 for k in ("planes", "fpga", "cascade",
                                               "cascade_response")),
            "a kernel of the config-5 path was not launched")
    check_fpga_path(fgold, fres)

    # -- phase 5: timing and the host --------------------------------------
    def metric(name, value, unit):
        print(json.dumps({"metric": name, "value": value, "unit": unit,
                          "device": device_name,
                          "power_limit": power_limit}))

    timing = {}
    ops_synth = synth._operands(dev)
    casc_synth = tables["flagship_synth_64"][0]
    calls = {
        "planes": (lambda: cstep.planes(octs),
                   lambda: plane_mod.planes_plain(octs, cstep.plane_ops)),
        "grad_hist": (lambda: cstep.channels(planes),
                      lambda: chan_mod.grad_hist_plain(planes, cstep.interior,
                                                       cstep.smooth)),
        "cascade": (lambda: det.cascade(canvas),
                    lambda: casc_mod.cascade_masked_plain(
                        canvas, grid.valid, det.cascade_ops)),
        "cascade_response": (
            lambda: casc_mod.cascade_response(canvas, grid.valid, ops_synth),
            lambda: casc_mod.cascade_response_plain(canvas, grid.valid,
                                                    ops_synth)),
        "cascade_generic": (
            lambda: gen_mod.cascade_response_grid(canvas, casc_synth,
                                                  (12, 12), grid.valid),
            lambda: gen_mod.cascade_response_grid_plain(
                canvas, casc_synth, (12, 12), grid.valid)),
    }
    name0, name1 = FPGA_MODELS
    calls.update({
        "fpga": (lambda: c5[name0].channels(planes4k),
                 lambda: fpga_mod.fpga_channels_plain(
                     planes4k, c5[name0].ring, None, c5[name0].cf.fused_kind,
                     0)),
        "fpga_smooth": (lambda: c5[name1].channels(planes4k),
                        lambda: fpga_mod.fpga_channels_plain(
                            planes4k, c5[name1].ring, c5[name1].interior,
                            c5[name1].cf.fused_kind, 1)),
        "cascade_c5": (lambda: det5.cascade(canvas4k[name0]),
                       lambda: casc_mod.cascade_masked_plain(
                           canvas4k[name0], det5.grid.valid,
                           det5.cascade_ops)),
    })
    for name, (kern, plain) in calls.items():
        # plain, kernel, kernel, plain: both orders inside one call
        big = name in ("fpga", "fpga_smooth", "cascade_c5")
        p1 = cuda_ms(plain, 1 if big else 3)
        k1 = cuda_ms(kern, 10 if big else 20)
        k2 = cuda_ms(kern, 10 if big else 20)
        p2 = cuda_ms(plain, 1 if big else 3)
        timing[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        metric(f"{name}_kernel_us_per_image", timing[name][0] * 1e3 / BATCH,
               "us/image")
        metric(f"{name}_plain_us_per_image", timing[name][1] * 1e3 / BATCH,
               "us/image")

    # the least time of each kernel's call at these shapes: bytes (each
    # input read once, each output written once) over the HBM rate, or its
    # arithmetic over the peak rate of its type
    pt = cstep.plane_ops
    level_elems = int(pt.host.meta[:, -1].sum()) * BATCH
    nw_synth = int(casc_mod.cascade_response(canvas, grid.valid,
                                             ops_synth)[2].sum())
    resp_out = BATCH * grid.valid.numel() * 5 + 4 * BATCH
    bounds = {
        "planes": bound(nbytes(octs, planes, pt.meta, pt.blocks, pt.i0h,
                               pt.frh, pt.i0w, pt.frw),
                        f32_ops=12 * level_elems),
        "grad_hist": bound(nbytes(planes, cstep.interior, canvas),
                           f32_ops=35 * canvas.numel(),
                           f64_ops=12 * canvas.numel()),
        "cascade": bound(nbytes(canvas, grid.valid, *casc,
                                *det.cascade_ops.tables,
                                det.cascade_ops.theta),
                         f32_ops=4 * int(casc[1].sum())),
        "cascade_response": bound(nbytes(canvas, grid.valid,
                                         *ops_synth.tables, ops_synth.theta)
                                  + resp_out, f32_ops=4 * nw_synth),
        "cascade_generic": bound(nbytes(canvas, grid.valid, casc_synth.fr,
                                        casc_synth.fc, casc_synth.fch,
                                        casc_synth.thr, casc_synth.left,
                                        casc_synth.right, casc_synth.pred,
                                        casc_synth.theta, casc_synth.active)
                                 + resp_out, f32_ops=4 * nw_synth),
    }
    # B5: integer work counted at the f32 rate, per pooled pixel the four
    # Sobel pairs (56 operations) and per channel the four responses,
    # quantizations, selects and the wrap pool (25), plus the smooth (18)
    n_pix = BATCH * det5.packed.canvas_h * det5.packed.canvas_w
    n_out = c5[name0].cf.n_channels
    canvas5 = canvas4k[name0]
    bounds["fpga"] = bound(nbytes(planes4k, c5[name0].ring, canvas5),
                           f32_ops=n_pix * (56 + 25 * n_out))
    bounds["fpga_smooth"] = bound(
        nbytes(planes4k, c5[name1].ring, c5[name1].interior, canvas5),
        f32_ops=n_pix * (56 + 43 * n_out))
    bounds["cascade_c5"] = bound(nbytes(canvas5, det5.grid.valid, *casc5,
                                        *det5.cascade_ops.tables,
                                        det5.cascade_ops.theta),
                                 f32_ops=4 * int(casc5[1].sum()))
    for name, (ms, what) in bounds.items():
        metric(f"{name}_bound_us_per_image", ms * 1e3 / BATCH, "us/image")
        print(f"{name}: bound by {what}; kernel at "
              f"{bounds[name][0] / timing[name][0]:.3f} of its bound")

    # per-layer device time on the noise batch (k=1024 detector, and the
    # config-5 smooth-0 k=128 detector); the extraction is timed with and
    # without the NMS that follows it
    for prefix, d, cs, imgs, o, p, cv, (mk, _, cnt) in (
            ("", det, cstep, noise[1], octs, planes, canvas, casc),
            ("c5_", det5, c5[name0], noise4k[1], octs4k, planes4k, canvas5,
             casc5)):
        g = d.grid
        layers = {
            "octaves": lambda: cs.octaves(imgs),
            "planes": lambda: cs.planes(o),
            "channels": lambda: cs.channels(p),
            "cascade": lambda: d.cascade(cv),
            "extract": lambda: extract_detections(
                mk, cnt, g.level_id, g.offsets, g.inv_scales, d.window, d.k),
            "extract_nms": lambda: d.extract(mk, cnt),
        }
        for name, fn in layers.items():
            metric(f"{prefix}layer_{name}_us_per_image",
                   cuda_ms(fn, 10 if not prefix else 3) * 1e3 / BATCH,
                   "us/image")

    def e2e(workload, fn_, batches, reps=60):
        """Host clock per batch call, each ending in a synchronize."""
        for b in batches[:2]:
            fn_(b)
        torch.cuda.synchronize()
        ms, pixels = [], 0
        for r in range(reps):
            images = batches[r % len(batches)]
            t = time.perf_counter()
            fn_(images)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            pixels += images.numel()
        med, p80 = np.percentile(ms, [50, 80])
        metric(f"{workload}_mp_per_s", pixels / sum(ms) / 1e3, "MP/s")
        metric(f"{workload}_batch_ms_p50", float(med), "ms")
        metric(f"{workload}_batch_ms_p80", float(p80), "ms")
        print(f"{workload}: {reps} batches of {BATCH}")

    det128, _ = wt.make_batched_detector_boxes(synth, VGA, k=128,
                                               nms_iou=0.5, device=dev)
    workloads = {
        "vga_full_pyramid_noise_k128": (det128, noise),
        "vga_full_pyramid_scene_k1024": (det, [scene,
                                               torch.flip(scene, dims=[2])]),
    }
    torch.cuda.reset_peak_memory_stats(dev)
    for workload, (fn_, batches) in workloads.items():
        e2e(workload, fn_, batches)
    metric("peak_device_memory_mib",
           torch.cuda.max_memory_allocated(dev) / 2 ** 20, "MiB")
    e2e("batched_detector_vga_scene", fn_full,
        [scene, torch.flip(scene, dims=[2])], reps=30)
    # config 5 as bench.py runs it: k=128, NMS 0.5, uniform noise
    workloads5 = {"fpga_4k_quantized_k128": (dets4k[name0], noise4k),
                  "fpga_4k_smooth_k128": (dets4k[name1], noise4k)}
    torch.cuda.reset_peak_memory_stats(dev)
    for workload, (fn_, batches) in workloads5.items():
        e2e(workload, fn_, batches, reps=20)
    metric("c5_peak_device_memory_mib",
           torch.cuda.max_memory_allocated(dev) / 2 ** 20, "MiB")

    def per_frame(name, fn_, n=30):
        """Host clock per call on one numpy frame, p50 over ``n`` frames
        (the scene batch's frames in turn); each call returns host data."""
        fn_(scene_np[0])
        ms = []
        for r in range(n):
            t = time.perf_counter()
            fn_(scene_np[r % BATCH])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        metric(f"{name}_ms_per_frame_p50", float(np.median(ms)), "ms")

    per_frame("model_detect_synth64", synth.detect)
    per_frame("model_detect_hard256", hard256.detect)
    per_frame("wt_detect_three_models",
              lambda f: wt.detect(f, *models.values(), response_scale=scales))
    print(f"host: {len(os.sched_getaffinity(0))} usable cores, load "
          f"average {os.getloadavg()}")
    for name, value in host_probe().items():
        metric(name, value, "ms" if name.endswith("_ms") else "us")

    # -- phase 6: profiler trace of each serving workload ------------------
    from torch.profiler import ProfilerActivity, profile, record_function
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="wb_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    n_traced = dict.fromkeys(workloads, 10)
    n_traced.update(dict.fromkeys(workloads5, 3))
    for workload, (fn_, batches) in {**workloads, **workloads5}.items():
        fn_(batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("smoke.window"):
                for r in range(n_traced[workload]):
                    fn_(batches[r % len(batches)])
                    torch.cuda.synchronize()
        path = os.path.join(trace_dir, f"{workload}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            bd = trace_breakdown(json.load(f), "smoke.window")
        if args.trace_dir is None:
            os.remove(path)
        print(f"trace {workload}: {n_traced[workload]} batches in "
              f"{bd['window_ms']:.3f} ms, "
              f"device busy {bd['device_busy_ms']:.3f} ms "
              f"({bd['n_device_events']} device events)")
        for layer, t in bd["layers"].items():
            print(f"  {layer}: host {t['host_ms']:.3f} ms, device "
                  f"{t['device_ms']:.3f} ms")
        if bd["n_device_events"]:
            metric(f"{workload}_device_idle_share", bd["device_idle_share"],
                   "1")
        else:
            print(f"trace {workload}: the profiler recorded no device "
                  f"events; device idle share not measured")
    if args.trace_dir is None:
        os.rmdir(trace_dir)

    # launches: the Model-API path's, and B5's from the config-5 path
    launches = dict(path_launches, fpga=fpga_launches["fpga"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, (_, _, src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
