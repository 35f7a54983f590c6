#!/usr/bin/env python3
"""Variants of the port's kernels B1 (csrc/planes.cu), B2
(csrc/grad_hist.cu), B2d and B2f (csrc/grad_hist_float.cu), B5
(csrc/fpga.cu) and the cascade walk (csrc/cascade.cu: B3, B4, B6) on one
NVIDIA GPU, each held bitwise against the kernel's plain version and
timed.

A variant is the committed source with textual edits, built by nvcc as
waldboost_tpu_torch/_build.py builds the source (all variants at once),
swapped in as the package's library for that source and launched through
the package's own wrappers:

* a launch bound or a tuning constant (the choices of the source), B1's
  tile shape, tile order (the package's row-major one, or grouped by the
  octave their levels read) or image order, or the walk's launch without
  its cached occupancy query;
* ``poison``: shared memory filled with a pattern before every use, so a
  read of a byte that no thread wrote changes the output;
* ``skew``: alternate warps (B1: also alternate lanes) delayed at every
  phase, so a missing barrier changes the output;
* ``ablation``: work removed (the values differ by design): timed only,
  its mismatch count printed, never a failure;
* ``cause``: one of a former design's suspected costs put back into
  the committed one (scalar shared reads, 4-byte copies, f64 conversions), the
  values unchanged, so held bitwise like any variant.

The walk also runs on GENERAL records of the depth-2 models (the tables
packed as for deeper trees) with the committed build.

Checks of every variant: B1 into buffers pre-filled with 0xAB (a gap byte
it misses is a mismatch) at VGA, BASELINE config 3's 1080p and config 5's
4K halo 0 (batch 8 of noise), and at 18x18, 97x131 (halo 0) and 61x95 (one
byte off a word); B2 on the VGA and 1080p planes (batch 8), smooth 0 and
1, and at 3x5, 17x45 and 70x257 planes (batch 3, 1, 3, random masks, one
byte off a word); B2d and B2f (uint8, bfloat16 and float32 planes) on
random VGA and 1080p planes (batch 8, smooth 0 and 1) and at 3x5, 17x45,
70x257, 33x132 and 70x256 (batch 3, 1, 3, 2, 2, random masks, planes and
mask also one element off their aligned start), B2f on the bfloat16
bits; B5 on the config-5 planes (4K noise, batch 8, both
committed models' composite, smooth 0 and 1) and at chip_smoke.py's tiling
edges (3x5, 17x45 and 70x257 planes, batch 3, 1, 3, one byte off a word,
C = 1, 4, 5, both smooths); the walk: B3 and B4 at C = 5 (4K), B3 and B6
at VGA (flagship_synth_64, noise batch 8), B3 and B4 with the seeded
40-stage depth-5 model, and chip_smoke.py's small grids with that model
and a 256-stage one whose records exceed the shared-memory budget.
Times: CUDA events, the mean of two turns of 20 calls at the batch-8
shapes, and host microseconds per call on a tiny input (the median of 5
turns of 200 calls; B1 18x18, B2 8x8, B4 one tile of origins); the
committed build is timed first and last.  Then 20 alternating pairs of the
committed walk and the one that queries the device at every launch, on
the host clock.

Prints the card line, one line per variant (ms, mismatches, ptxas
registers and spill stores per kernel instance), the static SASS counts
of conversions, f64 operations, shared loads, copies and shuffles of the
committed B2d/B2f build (cuobjdump), a JSON summary as the
last line (also written to --out), and exits 1 if a variant other than an
ablation differs from the plain version.

Usage: python scripts/sweep_torch_kernels.py
           [--only planes,grad_hist,grad_hist_float,fpga,walk]
           [--out FILE]   (grad_hist: B2, B2d and B2f; grad_hist_float:
                          B2d and B2f alone)
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BATCH = 8
VGA = (480, 640)

# -- variants ----------------------------------------------------------------

FPGA_BOUND = "__launch_bounds__(kThreads, kBlocksPerSm)"
FPGA_RING_STAGE = "  stage<4, T::kRingRows>(sR, ring, H, W, I0 - 1, J0 - 4);\n"
FPGA_IMAGE_TOP = ("    __syncthreads();  // the previous image is done with "
                  "sP / sPo\n")
FPGA_RING_CELLS = ("    // the pooled ring columns -1 and kTW (rows -1 .. "
                   "kTH), then the smooth\n")
FPGA_SMOOTH_TOP = ("    __syncthreads();\n#pragma unroll 1\n"
                   "    for (int il = ty; il < T::kTH; il += kBY) {\n")

FPGA_POISON = [
    (FPGA_RING_STAGE,
     "  for (int i = threadIdx.y * kBX + threadIdx.x;\n"
     "       i < 4 * T::kRingRows * kWords; i += kThreads)\n"
     "    sR[i] = 0xA5A5A5A5u ^ (blockIdx.x * 0x9E3779B9u);\n"
     "  for (int i = threadIdx.y * kBX + threadIdx.x;\n"
     "       i < (kSmooth ? T::kTH * kWords : 1); i += kThreads)\n"
     "    sI[i] = 0x3C3C3C3Cu ^ blockIdx.y;\n"
     "  __syncthreads();\n" + FPGA_RING_STAGE),
    (FPGA_IMAGE_TOP,
     FPGA_IMAGE_TOP +
     "    for (int i = ty * kBX + tx; i < 4 * T::kPlaneRows * kWords;\n"
     "         i += kThreads)\n"
     "      sP[i] = 0x5A5A5A5Au ^ (b * 0x01000193u);\n"
     "    if (kSmooth)\n"
     "      for (int i = ty * kBX + tx; i < cd.n * T::kPoolRows * kWords;\n"
     "           i += kThreads)\n"
     "        sPo[i] = 0xC3C3C3C3u ^ (b * 0x9E3779B9u) ^ blockIdx.x;\n"
     "    __syncthreads();\n"),
]
FPGA_SKEW = [
    (FPGA_IMAGE_TOP,
     FPGA_IMAGE_TOP + "    if ((ty ^ b) & 1) __nanosleep(4000);\n"),
    (FPGA_RING_CELLS,
     "    if (!((ty ^ b) & 1)) __nanosleep(4000);\n" + FPGA_RING_CELLS),
    (FPGA_SMOOTH_TOP,
     "    __syncthreads();\n    if ((ty ^ b) & 1) __nanosleep(4000);\n"
     + FPGA_SMOOTH_TOP[len("    __syncthreads();\n"):]),
]


def fpga_bound(n):
    return [(FPGA_BOUND, f"__launch_bounds__(kThreads, {n})")]


#: label -> (edits, ablation)
FPGA_VARIANTS = {"committed (minblocks 6)": ([], False)}
FPGA_VARIANTS.update({f"minblocks {n}": (fpga_bound(n), False)
                      for n in (1, 2, 3, 4, 5, 7, 8)})
FPGA_VARIANTS.update({
    "poison": (FPGA_POISON, False),
    "poison+skew": (FPGA_POISON + FPGA_SKEW, False),
    "poison+skew minblocks 1": (FPGA_POISON + FPGA_SKEW + fpga_bound(1),
                                False),
    "ablation: no smooth ring columns": (
        [("    if (tid < 2 * T::kPoolRows)\n", "    if (tid < 0)\n")], True),
    "ablation: no smooth (stub)": (
        [("        smooth4(sPo + (k * T::kPoolRows + il) * kWords, tx, in, "
          "v);", "        v[0] = v[1] = v[2] = v[3] = in & 63;")], True),
})

WALK_BOUND = "__launch_bounds__(kBlock)"
WALK_QUEUES = "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
WALK_POISON = [(WALK_QUEUES, WALK_QUEUES +
                "  for (int i = lane; i < kQueue; i += 32) {\n"
                "    q_out[warp][i] = 0x7ead0000 | i;\n"
                "    q_cv[warp][i] = -1 - i;\n"
                "    q_bt[warp][i] = 0x7fff0000 | i;\n"
                "    q_hs[warp][i] = __int_as_float(0x7fc00000 | i);\n"
                "  }\n  __syncwarp();\n")]


def walk_const(name, value):
    pat = re.compile(rf"constexpr int {name} = \d+;")
    return [(pat, f"constexpr int {name} = {value};")]


WALK_VARIANTS = {"committed": ([], False)}
WALK_VARIANTS.update({f"kRejects {n}": (walk_const("kRejects", n), False)
                      for n in (2, 3, 6, 8)})
WALK_VARIANTS.update({f"kChunk {n}": (walk_const("kChunk", n), False)
                      for n in (1, 8)})
WALK_VARIANTS.update({
    f"minblocks {n}": ([(WALK_BOUND, f"__launch_bounds__(kBlock, {n})")],
                       False) for n in (6, 8)})
WALK_VARIANTS["poison"] = (WALK_POISON, False)
WALK_VARIANTS["device queries at every launch"] = ([(
    "  if (it != fit.end()) return it->second;\n",
    "  (void)it;  // no cache: query at every launch\n")], False)
WALK_VARIANTS["prefetch: HEAP2 stage t+1 loaded before t's compares"] = ([(
    "        while (t < a.n_run) {\n"
    "          const Heap2 h = fetch(s, t, w);\n",
    "        Heap2 nx;\n"
    "        if (t < a.n_run) nx = fetch(s, t, w);\n"
    "        while (t < a.n_run) {\n"
    "          const Heap2 h = nx;\n"
    "          if (t + 1 < a.n_run) nx = fetch(s, t + 1, w);\n")], False)


# B3f (csrc/cascade_fast.cu).  A variant: (edits, ablation, host settings
# of ops/cascade.py: FRONT_REJECTS, FRONT_FOOTPRINT_BYTES).  The host
# builds the front's records for the tile the built library reports.
WF_PRODUCER = ("        uint8_t* dst = sBuf + k * a.fbytes;\n"
               "        if (lane == 0) {\n")
WF_CONSUMER = ("    if (kBuffers) mbar_wait(full + k, (i / kBuffers) & 1u);\n")
WF_EMPTY = "        if (use) mbar_wait(empty + k, (use - 1) & 1u);\n"
WF_QUEUE = "  const int rl = tid / kRowThreads, cl = (tid - rl * kRowThreads) * kP;\n"
WF_POISON = [
    (WF_PRODUCER,
     "        uint8_t* dst = sBuf + k * a.fbytes;\n"
     "        for (int j = lane; j < a.fbytes / 4; j += 32)\n"
     "          reinterpret_cast<uint32_t*>(dst)[j] =\n"
     "              0x7fc07fc0u ^ (j * 0x9E3779B9u) ^ (i << 8) ^ blockIdx.x;\n"
     "        fence_proxy_async();\n"
     "        __syncwarp();\n"
     "        if (lane == 0) {\n"),
    (WF_QUEUE, WF_QUEUE +
     "  for (int j = lane; j < kQueue; j += 32) {\n"
     "    q.out[j] = 0x7ead0000 | j;\n"
     "    q.cv[j] = -1 - j;\n"
     "    q.bt[j] = 0x7fff0000 | j;\n"
     "    q.hs[j] = __int_as_float(0x7fc00000 | j);\n"
     "  }\n  __syncwarp();\n")]
WF_SKEW = [
    (WF_CONSUMER, WF_CONSUMER +
     "    if ((warp ^ i) & 1) __nanosleep(3000);\n"),
    (WF_EMPTY, WF_EMPTY + "        if (i & 1) __nanosleep(2000);\n")]


def wf_const(name, value):
    pat = re.compile(rf"constexpr (int) {name} = [^;]+;")
    return [(pat, lambda m: f"constexpr {m.group(1)} {name} = {value};")]


def wf_tile(rows, cols, p):
    return [(re.compile(r"constexpr int kTR = \d+, kTC = \d+;"),
             f"constexpr int kTR = {rows}, kTC = {cols};")] + \
        wf_const("kP", p)


WALK_FAST_VARIANTS = {"committed": ([], False, {})}
for _r, _c, _p in ((8, 32, 1), (8, 32, 4), (16, 64, 8), (32, 64, 4),
                   (32, 64, 8)):
    WALK_FAST_VARIANTS[f"tile {_r} x {_c}, {_p} origins a thread"] = (
        wf_tile(_r, _c, _p), False, {})
WALK_FAST_VARIANTS.update({
    f"kFront {n}": ([], False, {"FRONT_REJECTS": n}) for n in (1, 2, 3)})
WALK_FAST_VARIANTS.update({
    "no front (every window to the walk)": ([], False, {"FRONT_REJECTS": 0}),
    "front from global memory (no staging)": (
        [], False, {"FRONT_FOOTPRINT_BYTES": 0}),
    "one buffer": (wf_const("kBufs", 1), False, {}),
    "three buffers": (wf_const("kBufs", 3), False, {}),
    "kRejects 2": (wf_const("kRejects", 2), False, {}),
    "kRejects 8": (wf_const("kRejects", 8), False, {}),
    "kAhead 1 (one stage's loads at a time)": (wf_const("kAhead", 1), False,
                                               {}),
    "kAhead 8": (wf_const("kAhead", 8), False, {}),
    "launch bound 4 blocks an SM": ([(
        "__global__ void __launch_bounds__(kThreads + 32)",
        "__global__ void __launch_bounds__(kThreads + 32, 4)")], False, {}),
    "ablation: no walk after the last tile (queued windows stay -inf)": ([(
        "  drain(true);\n  flush(nw, cnt, wb, a);",
        "  flush(nw, cnt, wb, a);")], True, {}),
    "poison": (WF_POISON, False, {}),
    "skew": (WF_SKEW, False, {}),
    "poison+skew": (WF_POISON + WF_SKEW, False, {}),
    "ablation: no walk (survivors dropped)": ([(
        "const unsigned queued = finish ? 0u : alive;",
        "const unsigned queued = 0u;")], True, {}),
    "ablation: no stores of the front": ([(
        "      store(dst, o, a.vec_out && n_in == kP, n_in);",
        "      if (o[0] == 1.2345f) store(dst, o, a.vec_out && n_in == kP,"
        " n_in);")], True, {}),
    "tiles the grid's width apart (not a run a block)": ([(
        "  const int lo = static_cast<int>(static_cast<long long>(a.n_tiles) *\n"
        "                                  blockIdx.x / gridDim.x);\n"
        "  const int n_mine = static_cast<int>(static_cast<long long>(a.n_tiles) *\n"
        "                                      (blockIdx.x + 1) / gridDim.x) - lo;\n",
        "  const int n_mine = (a.n_tiles - 1 - static_cast<int>(blockIdx.x)) /\n"
        "                     static_cast<int>(gridDim.x) + 1;\n"),
        ("    const int tile = lo + i;",
         "    const int tile = blockIdx.x + i * gridDim.x;")], False, {}),
    "the mask read after the footprint's wait": ([
        ("    // the mask is read above while the footprint is still on its "
         "way\n    if (kBuffers) mbar_wait(full + k, (i / kBuffers) & 1u);\n",
         ""),
        ("    const int k = kBuffers ? i % kBuffers : 0;\n",
         "    const int k = kBuffers ? i % kBuffers : 0;\n"
         "    if (kBuffers) mbar_wait(full + k, (i / kBuffers) & 1u);\n")],
        False, {}),
})


PLANES_BOUND = "__global__ void __launch_bounds__(kThreads)\nplanes_kernel("
PLANES_V = "      __syncwarp();  // the previous piece is done with V\n"
PLANES_ROW = "    uint32_t w[4] = {0, 0, 0, 0};\n"
PLANES_POISON = [(PLANES_V, PLANES_V +
                  "      for (int k = lane; k < 2 * kVMax; k += 32)\n"
                  "        sV[warp][k / kVMax][k % kVMax] = 0x5A5A5A5A ^ "
                  "(k * 0x01000193) ^ y;\n"
                  "      __syncwarp();\n")]
PLANES_SKEW = [(PLANES_ROW, PLANES_ROW +
                "    if ((warp ^ y ^ blockIdx.x) & 1) __nanosleep(2000);\n"),
               (PLANES_V,
                PLANES_V + "      if (lane & 1) __nanosleep(1000);\n")]


def planes_const(name, value):
    pat = re.compile(rf"constexpr int {name} = \d+;")
    return [(pat, f"constexpr int {name} = {value};")]


#: label -> (edits, ablation, tables' (tile rows, tile cols, order))
PLANES_VARIANTS = {"committed": ([], False, (16, 128, "raster"))}
PLANES_VARIANTS.update({
    f"minblocks {n}": ([(PLANES_BOUND, PLANES_BOUND.replace(
        "(kThreads)", f"(kThreads, {n})"))], False, (16, 128, "raster"))
    for n in (4, 8)})
PLANES_VARIANTS.update({
    f"tile rows {r}": (planes_const("kTR", r), False, (r, 128, "raster"))
    for r in (8, 32)})
PLANES_VARIANTS.update({
    "8 warps a block": (planes_const("kWarps", 8), False,
                        (16, 128, "raster")),
    "tiles grouped by octave (each octave's levels together, L2)": (
        [], False, (16, 128, "octave")),
    "images interleaved (grid tiles x batch, batch fastest)": ([
        ("    dim3 grid(n_tiles, batch);", "    dim3 grid(batch, n_tiles);"),
        ("reinterpret_cast<const int4*>(tiles) + blockIdx.x);",
         "reinterpret_cast<const int4*>(tiles) + blockIdx.y);"),
        ("  const uint8_t* img = octs + blockIdx.y * oct_stride;",
         "  const uint8_t* img = octs + blockIdx.x * oct_stride;"),
        ("static_cast<size_t>(blockIdx.y) * 4 * plane;",
         "static_cast<size_t>(blockIdx.x) * 4 * plane;")],
        False, (16, 128, "raster")),
    "no copy path for den 1 x 1 levels": ([(
        "      if (r2_.w == 1 && r3_.x == 1) {",
        "      if (false) {")], False, (16, 128, "raster")),
    "ablation: no blend rows filled": ([(
        "        for (int k = 4 * lane; k < n; k += 128) {",
        "        for (int k = 4 * lane; k < 0; k += 128) {")], True,
        (16, 128, "raster")),
    "poison": (PLANES_POISON, False, (16, 128, "raster")),
    "poison+skew": (PLANES_POISON + PLANES_SKEW, False, (16, 128, "raster")),
})

GH_BOUND = "__launch_bounds__(kThreads, kBlocksPerSm)"
GH_IMAGE_TOP = ("    __syncthreads();  // the previous image is done with "
                "sPo, other buffer\n")
GH_FIRST = ("  // the planes of the next image are staged while this one is "
            "computed\n")
GH_RING = ("    // the pooled ring columns -1 and kTW (rows -1 .. kTH), then "
           "the smooth\n")
GH_SMOOTH_TOP = "    __syncthreads();\n#pragma unroll 1\n    for (int il = ty;"
GH_POISON = [
    ("  if (kSmooth) stage<1, T::kTH>(sI, mask, H, W, I0, J0 - 4, false);\n",
     "  for (int i = threadIdx.y * kBX + threadIdx.x;\n"
     "       i < T::kMask + 2 * T::kPlanes; i += kThreads)\n"
     "    sPbuf[i] = 0x3C3C3C3Cu ^ blockIdx.y ^ i;\n"
     "  __syncthreads();\n"
     "  if (kSmooth) stage<1, T::kTH>(sI, mask, H, W, I0, J0 - 4, false);\n"),
    (GH_IMAGE_TOP, GH_IMAGE_TOP +
     "    for (int i = ty * kBX + tx; i < T::kPlanes; i += kThreads)\n"
     "      sPbuf[(buf ^ 1) * T::kPlanes + i] = 0x5A5A5A5Au ^ (b * "
     "0x01000193u);\n"
     "    for (int i = ty * kBX + tx; i < T::kPooled + T::kRing; "
     "i += kThreads)\n"
     "      sPo[i] = __int_as_float(0x7fc00000 | i);\n"
     "    __syncthreads();  // poisoned before any thread stages\n"),
]
GH_SKEW = [
    (GH_IMAGE_TOP,
     GH_IMAGE_TOP + "    if ((ty ^ b) & 1) __nanosleep(4000);\n"),
    (GH_RING, "    if (!((ty ^ b) & 1)) __nanosleep(4000);\n" + GH_RING),
    (GH_SMOOTH_TOP, "    __syncthreads();\n    if ((ty ^ b) & 1) "
     "__nanosleep(4000);\n#pragma unroll 1\n    for (int il = ty;"),
]

GH_VARIANTS = {"committed (minblocks 5)": ([], False)}
GH_VARIANTS.update({f"minblocks {n}": ([(GH_BOUND,
                                         f"__launch_bounds__(kThreads, {n})")],
                                       False) for n in (2, 3, 4)})
GH_VARIANTS.update({
    "smooth as multiply, then add (no fused exact terms)": ([
        (re.compile(r"__fmaf_rn\(([24]\.0f), (p\[\d\]\[g( \+ \d)?\]), s\)"),
         r"__fadd_rn(s, __fmul_rn(\1, \2))")], False),
    "int to f64 by conversion": ([(
        "  const double dx = to_double(gx), dy = to_double(gy);",
        "  const double dx = gx, dy = gy;")], False),
    "ablation: bins in f32": ([(
        "    const float b = fabsf(__double2float_rn(\n"
        "        __dsub_rn(__dmul_rn(dx, pj.c[k]), __dmul_rn(dy, pj.s[k]))));",
        "    const float b = fabsf(__fsub_rn(\n"
        "        __fmul_rn(gx, static_cast<float>(pj.c[k])),\n"
        "        __fmul_rn(gy, static_cast<float>(pj.s[k]))));")],
        True),
    "ablation: planes staged once for the batch": ([(
        "    if (b + gridDim.z < batch)\n      stage<4",
        "    if (false)\n      stage<4"), (
        "    const uint32_t* sP = sPbuf + buf * T::kPlanes;",
        "    const uint32_t* sP = sPbuf;")], True),
    "planes staged synchronously (no cp.async)": ([(
        "  const bool async = W % 4 == 0 &&",
        "  const bool async = false && W % 4 == 0 &&")], False),
    "smooth: bins loop not unrolled": ([(
        "#pragma unroll\n      for (int k = 0; k < kBins; ++k) {\n"
        "        // pooled rows il-1",
        "#pragma unroll 1\n      for (int k = 0; k < kBins; ++k) {\n"
        "        // pooled rows il-1")], False),
    "ablation: no smooth ring columns": ([(
        "    if (tid < 2 * T::kPoolRows) {", "    if (tid < 0) {")], True),
    "ablation: smooth stubbed (centre only)": ([(
        "          v[g] = ((in >> (8 * g)) & 255u) ? __fmul_rn(s, 0.0625f) : "
        "0.0f;", "          v[g] = p[1][g + 1];")], True),
    "poison": (GH_POISON, False),
    "poison+skew": (GH_POISON + GH_SKEW, False),
    "poison+skew minblocks 1": (GH_POISON + GH_SKEW + [(
        GH_BOUND, "__launch_bounds__(kThreads, 1)")], False),
})


# B2d and B2f (csrc/grad_hist_float.cu)
GHF_START = "  if (tma && lead) {\n"
GHF_TOP = ("    __syncthreads();  // the previous item is done with sPo, other "
           "buffer\n")
GHF_ONE = ("      __syncthreads();  // the planes are read: copy the next "
           "item's in\n")
GHF_ITEM = "    const int j0 = J0 + 4 * tx;\n"
GHF_RING = "    if (kSmooth && tx < 4) {\n"
GHF_SMOOTH = "    // the smooth, two adjacent rows a warp\n"
GHF_POISON = [
    (GHF_START,
     "  for (int i = threadIdx.y * kBX + threadIdx.x;\n"
     "       i < static_cast<int>(T::kBytes / 4); i += kThreads)\n"
     "    reinterpret_cast<uint32_t*>(smem)[i] = 0x3C3C3C3Cu ^ blockIdx.x ^ i;\n"
     "  __syncthreads();\n" + GHF_START),
    (GHF_TOP, GHF_TOP +
     "    for (int i = ty * kBX + tx; i < (T::kPooled + T::kRing) / 4;\n"
     "         i += kThreads)\n"
     "      reinterpret_cast<uint32_t*>(smem)[i] = 0x7fc00000u | i;\n"
     "    if (kBufs == 2) {\n"
     "      for (int i = ty * kBX + tx; i < T::kPlanes / 4; i += kThreads)\n"
     "        reinterpret_cast<uint32_t*>(sPbuf + (pb ^ 1) * T::kPlanes)[i] =\n"
     "            0x5A5A5A5Au ^ (static_cast<uint32_t>(it) * 0x01000193u);\n"
     "      for (int i = ty * kBX + tx; i < T::kMask / 4; i += kThreads)\n"
     "        reinterpret_cast<uint32_t*>(sM + (mb ^ 1) * T::kMask)[i] =\n"
     "            0xA5A5A5A5u ^ i;\n"
     "    }\n"
     "    __syncthreads();  // poisoned before any copy into them\n"),
    (GHF_ONE, GHF_ONE +
     "      for (int i = ty * kBX + tx; i < T::kPlanes / 4; i += kThreads)\n"
     "        reinterpret_cast<uint32_t*>(sPbuf)[i] =\n"
     "            0x5A5A5A5Au ^ (static_cast<uint32_t>(it) * 0x01000193u);\n"
     "      for (int i = ty * kBX + tx; i < T::kMask / 4; i += kThreads)\n"
     "        reinterpret_cast<uint32_t*>(sM + (mb ^ 1) * T::kMask)[i] =\n"
     "            0xA5A5A5A5u ^ i;\n"
     "      __syncthreads();  // poisoned before any copy into them\n"),
]
GHF_SKEW = [
    (GHF_ITEM, GHF_ITEM +
     "    if ((ty ^ static_cast<int>(it)) & 1) __nanosleep(4000);\n"),
    (GHF_RING,
     "    if (!((ty ^ static_cast<int>(it)) & 1)) __nanosleep(4000);\n"
     + GHF_RING),
    (GHF_SMOOTH, GHF_SMOOTH +
     "    if ((ty ^ static_cast<int>(it)) & 1) __nanosleep(4000);\n"),
]
def ghf_blocks(delta):
    """Each instance's launch bound (blocks an SM must hold) + delta."""
    def sub(m):
        return ", ".join(f"kBlocks{n} = {max(1, int(v) + delta)}" for n, v in
                         re.findall(r"kBlocks(\w+) = (\d+)", m.group(0)))
    return [(re.compile(r"kBlocksB2d = \d+, kBlocksF32 = \d+, "
                        r"kBlocksBf16 = \d+, kBlocksU8 = \d+"), sub)]


def ghf_const(name, value):
    return [(re.compile(rf"{name} = \d+"), f"{name} = {value}")]


GHF_VECTOR = "constexpr bool kVectorOf = kIn != 1;"

#: B2d's prefilters converting each operand in every tap (asm, so the
#: compiler cannot merge the conversions of one element)
GHF_PER_TAP = [(
    "  using W = double;\n"
    "  static constexpr bool kCheck = kBits;  // gradients must be finite\n"
    "  static __device__ __forceinline__ W widen(float v) {\n"
    "    if constexpr (kBits)\n"
    "      return __dmul_rn(scaled_f64(v), 0x1p896);\n"
    "    else\n"
    "      return static_cast<double>(v);\n"
    "  }\n"
    "  static __device__ __forceinline__ float tap(W a, W b, W c) {\n"
    "    return __double2float_rn(__dadd_rn(__dadd_rn(a, __dmul_rn(2.0, b)), "
    "c));\n"
    "  }\n",
    "  using W = float;\n"
    "  static constexpr bool kCheck = kBits;  // gradients must be finite\n"
    "  static __device__ __forceinline__ W widen(float v) { return v; }\n"
    "  static __device__ __forceinline__ double cvt(float v) {\n"
    "    double d;\n"
    "    asm volatile(\"cvt.f64.f32 %0, %1;\" : \"=d\"(d) : \"f\"(v));\n"
    "    return d;\n"
    "  }\n"
    "  static __device__ __forceinline__ float tap(W a, W b, W c) {\n"
    "    return __double2float_rn(__dadd_rn(\n"
    "        __dadd_rn(cvt(a), __dmul_rn(2.0, cvt(b))), cvt(c)));\n"
    "  }\n")]

GHF_VARIANTS = {
    "committed": ([], False),
    "poison": (GHF_POISON, False),
    "poison+skew": (GHF_POISON + GHF_SKEW, False),
    "minblocks -1 (each instance)": (ghf_blocks(-1), False),
    "minblocks +1 (each instance)": (ghf_blocks(+1), False),
    "minblocks without the smooth as with it": (
        ghf_const("kFewerBlocksSmooth0", 0), False),
    "two plane buffers with the smooth": (ghf_const("kBufsSmooth1", 2),
                                          False),
    "one plane buffer without the smooth": (ghf_const("kBufsSmooth0", 1),
                                            False),
    "uint8 rows as one 4-byte load and shuffles": ([(
        GHF_VECTOR, "constexpr bool kVectorOf = true;")], False),
    "cause: 4-byte copies (no TMA)": ([(
        "  const bool vec = (static_cast<size_t>(W) * kIn) % 16 == 0 &&",
        "  const bool vec = false && (static_cast<size_t>(W) * kIn) % 16 == 0 "
        "&&")], False),
    "cause: float rows by scalar shared reads (bank conflicts)": ([(
        GHF_VECTOR, "constexpr bool kVectorOf = false;")], False),
    "cause: B2d elements to f64 by conversion": ([(
        "    if constexpr (kBits)\n      return __dmul_rn(scaled_f64(v), "
        "0x1p896);", "    if constexpr (false)\n      return __dmul_rn("
        "scaled_f64(v), 0x1p896);")], False),
    "cause: B2d gradients to f64 by conversion": ([(
        "      const double dx = scaled_f64(gx), dy = scaled_f64(gy);\n"
        "      const double* c = pj.cu;\n      const double* s = pj.su;",
        "      const double dx = gx, dy = gy;\n"
        "      const double* c = pj.c;\n      const double* s = pj.s;")],
        False),
    "cause: B2d per-tap conversions (not merged)": (GHF_PER_TAP, False),
    "B2f bins each from their own products": ([(
        "    const float p = __fmul_rn(fx, pj.cf[1]), q = __fmul_rn(fy, "
        "pj.cf[1]);\n"
        "    b[1] = fabsf(__fsub_rn(p, q));\n"
        "    b[2] = fabsf(__fsub_rn(__fmul_rn(fx, pj.cf[2]), fy));\n"
        "    b[3] = fabsf(__fadd_rn(p, q));",
        "    for (int k = 1; k < kBins; ++k)\n"
        "      b[k] = fabsf(\n"
        "          __fsub_rn(__fmul_rn(fx, pj.cf[k]), __fmul_rn(fy, "
        "pj.sf[k])));")], False),
    "B2d ring cells by conversion": ([(
        "cell_bins<FloatChain<true>>(e, pj, v)",
        "cell_bins<FloatChain<false>>(e, pj, v)")], False),
    "ablation: no ring cells": ([(GHF_RING, "    if (kSmooth && tx < 0) {\n")],
                                True),
    "ablation: smooth stubbed (centre only)": ([(
        "          sm[g] = ((in >> (8 * g)) & 255u) ? __fmul_rn(s, 0.0625f) : "
        "0.0f;", "          sm[g] = p[o + 1][g + 1];")], True),
    "B2f uint8 gradients to f32 from their bits": ([(
        "      fx = __int2float_rn(gx);\n      fy = __int2float_rn(gy);",
        "      fx = __fsub_rn(__int_as_float(0x4b400000 + gx), 12582912.0f);\n"
        "      fy = __fsub_rn(__int_as_float(0x4b400000 + gy), 12582912.0f);")],
        False),
    "two passes of a thread unrolled together": ([(
        "#pragma unroll 1\n    for (int rr = 0; rr < 2; ++rr) {",
        "#pragma unroll\n    for (int rr = 0; rr < 2; ++rr) {")], False),
}


# -- building ----------------------------------------------------------------

def edit(text, edits, label):
    """``text`` with each (anchor, replacement) applied: a string anchor
    must occur once, a pattern at least once (every match is replaced)."""
    for old, new in edits:
        if isinstance(old, re.Pattern):
            text, n = old.subn(new, text)
            n = min(n, 1)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if n != 1:
            raise SystemExit(f"variant {label!r}: edit anchor found {n} "
                             f"times: {old!r}")
    return text


def ptxas_summary(log):
    """'registers/spill-store bytes' per kernel instance, in build order."""
    out, spill = [], 0
    for line in log.splitlines():
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{m.group(1)}r/{spill}s")
            spill = 0
    return " ".join(out)


def build_variants(_build, src_name, variants, workdir):
    """{label: (CDLL, ptxas summary)}, one nvcc per variant, at most as
    many at once as there are CPU cores."""
    with open(os.path.join(_build.CSRC, src_name + ".cu")) as f:
        base = f.read()
    jobs, running, done = [], [], {}
    for i, (label, (edits, *_)) in enumerate(variants.items()):
        src = os.path.join(workdir, f"{src_name}_{i}.cu")
        with open(src, "w") as f:
            f.write(edit(base, edits, label))
        jobs.append((label, src, src[:-3] + ".so"))
    width = max(1, os.cpu_count() or 1)
    while jobs or running:
        while jobs and len(running) < width:
            label, src, lib = jobs.pop(0)
            proc = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
                 lib, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            running.append((label, lib, proc))
        label, lib, proc = running.pop(0)
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {label!r}:\n{err}")
        done[label] = (ctypes.CDLL(lib), ptxas_summary(out + err))
    return done


# -- measuring ---------------------------------------------------------------

def mismatches(got, want):
    import torch
    torch.cuda.synchronize()
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def timed(cuda_ms, fn):
    return (cuda_ms(fn, 20) + cuda_ms(fn, 20)) / 2


def host_us(fn, calls=200, turns=5):
    """Host microseconds per call of ``fn`` when the card keeps up (a
    launch on a tiny input): the median of ``turns`` runs of ``calls``."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(turns):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per))


def host_pairs(_build, libs, a, b, fn, pairs=20):
    """Host microseconds per call of ``fn`` with the walk built as variant
    ``a`` and as ``b``, in ``pairs`` pairs alternating which runs first:
    each side's quartiles and how many pairs each side won."""
    per = {a: [], b: []}
    for i in range(pairs):
        for label in ((a, b) if i % 2 == 0 else (b, a)):
            _build._LIBS["cascade"] = libs[label][0]
            per[label].append(host_us(fn))
    _build._LIBS.pop("cascade", None)
    out = {label: {"quartiles_us": np.percentile(v, [25, 50, 75]).tolist(),
                   "runs_us": v} for label, v in per.items()}
    out[a]["wins"] = sum(x < y for x, y in zip(per[a], per[b]))
    out[b]["wins"] = sum(y < x for x, y in zip(per[a], per[b]))
    for label, r in out.items():
        q = ", ".join(f"{v:.2f}" for v in r["quartiles_us"])
        print(f"host pairs, B4 one tile, {label}: quartiles {q} us, won "
              f"{r['wins']} of {pairs}", flush=True)
    return out


def sweep(_build, name, variants, libs, checks, times, failures, rows,
          host=None):
    """Run every variant: swap its library in as csrc/<name>.cu's build,
    count mismatches over ``checks``, time ``times`` on the card and
    ``host`` on the host clock."""
    from chip_smoke import cuda_ms
    order = list(variants) + [next(iter(variants))]  # committed first, last
    for i, label in enumerate(order):
        lib, ptx = libs[label]
        _build._LIBS[name] = lib
        bad = sum(mismatches(check(), want) for check, want in checks)
        ms = {t: timed(cuda_ms, fn) for t, fn in times.items()}
        us = {t: host_us(fn) for t, fn in (host or {}).items()}
        ablation = variants[label][1]
        tag = label if i < len(variants) else label + " (again)"
        rows.append({"kernel": name, "variant": tag, "ms": ms,
                     "host_us": us, "mismatches": bad, "ablation": ablation,
                     "ptxas": ptx})
        print(f"{name} {tag}: " + ", ".join(f"{t} {v:.4f} ms"
                                            for t, v in ms.items())
              + "".join(f", {t} {v:.2f} us" for t, v in us.items())
              + f"; mismatches {bad}" + (" (ablation)" if ablation else "")
              + f"; ptxas {ptx}", flush=True)
        if bad and not ablation:
            failures.append(f"{name} {label}")
    _build._LIBS.pop(name, None)


def sweep_planes(_build, libs, dev, failures, rows):
    """B1's variants: each into a canvas pre-filled with 0xAB (a gap byte
    it misses is a mismatch) at VGA, 1080p and 4K halo 0 (batch 8 of
    noise) and three small frames (one into a buffer one byte off a word),
    then timed at the three batch-8 shapes."""
    import torch
    from chip_smoke import cuda_ms
    from waldboost_tpu_torch import channels as tch
    from waldboost_tpu_torch import packing, polyphase
    from waldboost_tpu_torch.ops import planes as tpl
    cases = {"VGA": ((480, 640), 8, 1, 8), "1080p": ((1080, 1920), 8, 1, 8),
             "4K": ((2160, 3840), 4, 0, 8), "18x18": ((18, 18), 2, 1, 3),
             "97x131 halo 0": ((97, 131), 2, 0, 1),
             "61x95 odd out": ((61, 95), 2, 1, 3)}
    gen = torch.Generator(device=dev).manual_seed(11)
    inputs, ops_cache = {}, {}
    for name, (hw, npo, halo, batch) in cases.items():
        window = (12, 12) if batch == 8 else (8, 8)
        packed = packing._packed_plan_cached(hw[0], hw[1], 2, npo, window,
                                             halo=halo)
        imgs = torch.randint(0, 256, (batch,) + hw, generator=gen,
                             dtype=torch.uint8, device=dev)
        n_oct = max(pl.level.octave for pl in packed.levels) + 1
        octs = tpl.octave_buffer(tch.level_octaves(imgs, n_oct))
        inputs[name] = (packed, hw, octs)

    def ops_for(name, tab):
        """The tables of a variant: its tile shape (the package's constants
        set while they are built) and tile order ("octave": the tiles
        sorted, stably, by the first octave their pieces read)."""
        key = (name, tab)
        if key not in ops_cache:
            packed, hw, _ = inputs[name]
            shape = (polyphase.PLANE_TILE_ROWS, polyphase.PLANE_TILE_COLS)
            tr, tc, order = tab or shape + ("raster",)
            polyphase.PLANE_TILE_ROWS, polyphase.PLANE_TILE_COLS = tr, tc
            try:
                t = polyphase.plane_tables(packed, packed.halo, hw)
            finally:
                polyphase.PLANE_TILE_ROWS, polyphase.PLANE_TILE_COLS = shape
            if order == "octave":
                off = polyphase.PIECE_COLS.index("oct_off")
                key_of = [t.pieces[b:e, off].min() if e > b else 1 << 40
                          for _, _, b, e in t.tiles]
                t = dataclasses.replace(t, tiles=t.tiles[np.argsort(
                    key_of, kind="stable")])
            ops_cache[key] = tpl.PlaneOperands.build(t, dev)
        return ops_cache[key]

    want = {name: tpl.planes_plain(octs, ops_for(name, None))
            for name, (_, _, octs) in inputs.items()}
    order = list(PLANES_VARIANTS) + [next(iter(PLANES_VARIANTS))]
    for i, label in enumerate(order):
        lib, ptx = libs[label]
        edits, ablation, tab = PLANES_VARIANTS[label]
        _build._LIBS["planes"] = lib
        run = {name: (lambda o, p: lambda out=None: tpl.planes(o, p,
                                                               out=out))(
            octs, ops_for(name, tab))
            for name, (_, _, octs) in inputs.items()}
        bad = 0
        for name, fn in run.items():
            buf = torch.full(tuple(want[name].shape) if "odd" not in name
                             else (want[name].numel() + 1,), 0xAB,
                             dtype=torch.uint8, device=dev)
            out = buf if "odd" not in name else buf[1:].view(want[name].shape)
            got = fn(out)
            bad += mismatches([got], [want[name]])
        ms = {name: timed(cuda_ms, run[name]) for name in ("VGA", "1080p",
                                                           "4K")}
        us = {"18x18 host": host_us(run["18x18"])}
        _build._LIBS.pop("planes", None)
        tag = label if i < len(PLANES_VARIANTS) else label + " (again)"
        rows.append({"kernel": "planes", "variant": tag, "ms": ms,
                     "host_us": us, "mismatches": bad, "ablation": ablation,
                     "ptxas": ptx})
        print(f"planes {tag}: " + ", ".join(f"{t} {v:.4f} ms"
                                            for t, v in ms.items())
              + "".join(f", {t} {v:.2f} us" for t, v in us.items())
              + f"; mismatches {bad}; ptxas {ptx}", flush=True)
        if bad and not ablation:
            failures.append(f"planes {label}")


def grad_hist_cases(dev):
    """``(checks, times)`` of B2's variants: VGA and 1080p planes of batch-8
    noise (the committed B1) with each plan's interior mask, both smooths,
    and the tiling edges (3x5, 17x45, 70x257 planes, batch 3, 1, 3, random
    masks, planes and mask one byte off a word)."""
    import torch
    from waldboost_tpu_torch import channels as tch
    from waldboost_tpu_torch import packing, polyphase
    from waldboost_tpu_torch.ops import channels as tcc
    from waldboost_tpu_torch.ops import planes as tpl
    gen = torch.Generator(device=dev).manual_seed(12)
    checks, times = [], {}
    for name, hw in (("VGA", (480, 640)), ("1080p", (1080, 1920))):
        packed = packing._packed_plan_cached(hw[0], hw[1], 2, 8, (12, 12),
                                             halo=1)
        t = polyphase.plane_tables(packed, packed.halo, hw)
        imgs = torch.randint(0, 256, (BATCH,) + hw, generator=gen,
                             dtype=torch.uint8, device=dev)
        planes = tpl.planes_plain(tpl.octave_buffer(tch.level_octaves(
            imgs, len(t.oct_hw))), tpl.PlaneOperands.build(t, dev))
        mask = torch.as_tensor(packed.smooth_interior_mask().astype(np.uint8),
                               device=dev)
        for sm in (0, 1):
            a = (planes, mask if sm else None, sm)
            fn = (lambda a: lambda: [tcc.grad_hist(*a)])(a)
            checks.append((fn, [tcc.grad_hist_plain(*a)]))
            times[f"{name} smooth {sm}"] = fn
    erng = np.random.RandomState(4)
    for ehw, eb in (((3, 5), 3), ((17, 45), 1), ((70, 257), 3)):
        buf = torch.from_numpy(erng.randint(0, 256, 4 * eb * ehw[0] * ehw[1]
                                            + 1).astype(np.uint8)).to(dev)
        eplanes = buf[1:].view((eb, 2, 2) + ehw)
        mbuf = torch.from_numpy((erng.rand(ehw[0] * ehw[1] + 1) < 0.8)
                                .astype(np.uint8)).to(dev)
        emask = mbuf[1:].view(ehw)
        for sm in (0, 1):
            a = (eplanes, emask if sm else None, sm)
            checks.append(((lambda a: lambda: [tcc.grad_hist(*a)])(a),
                           [tcc.grad_hist_plain(*a)]))
    return checks, times



#: B2d and B2f: (label, chain, plane type); B2f's plane types as torch's
GHF_KINDS = (("B2d", "float", "float32"), ("B2f uint8", "fast", "uint8"),
             ("B2f bf16", "fast", "bfloat16"), ("B2f f32", "fast", "float32"))
#: tiling edges (h, w, batch): widths off the 128-column tile, a float32
#: width no multiple of 4 (5, 45, 257), one a multiple of 4 but not of 8
#: (132), one of 16 (256)
GHF_EDGES = (((3, 5), 3), ((17, 45), 1), ((70, 257), 3), ((33, 132), 2),
             ((70, 256), 2))


def grad_hist_float_cases(dev):
    """``(checks, times)`` of B2d's and B2f's variants: random planes of
    the VGA and 1080p plans (batch 8; uint8, bfloat16 and float32 from one
    draw in [0, 256)) with each plan's interior mask, both smooths, timed;
    and the tiling edges of GHF_EDGES with random masks, the planes and
    mask also one element off their aligned start (float32: 4 bytes off
    16), both smooths.  B2f is compared on the bfloat16 bits."""
    import torch
    from waldboost_tpu_torch import packing
    from waldboost_tpu_torch.ops import channels as tcc
    gen = torch.Generator(device=dev).manual_seed(14)
    checks, times = [], {}

    def case(chain, p, m, sm):
        if chain == "float":
            return ((lambda: [tcc.grad_hist_float(p, m, sm)]),
                    [tcc.grad_hist_float_plain(p, m, sm)])
        return ((lambda: [tcc.grad_hist_fast(p, m, sm).view(torch.int16)]),
                [tcc.grad_hist_fast_plain(p, m, sm).view(torch.int16)])

    for name, hw in (("VGA", (480, 640)), ("1080p", (1080, 1920))):
        packed = packing._packed_plan_cached(hw[0], hw[1], 2, 8, (12, 12),
                                             halo=1)
        H, W = packed.canvas_h, packed.canvas_w
        vals = torch.rand((BATCH, 2, 2, H, W), generator=gen,
                          device=dev) * 256
        mask = torch.as_tensor(packed.smooth_interior_mask().astype(np.uint8),
                               device=dev)
        for label, chain, dtype in GHF_KINDS:
            p = vals.to(getattr(torch, dtype))
            for sm in (1, 0):
                fn, want = case(chain, p, mask if sm else None, sm)
                checks.append((fn, want))
                times[f"{name} {label} smooth {sm}"] = fn
    erng = np.random.RandomState(5)
    for ehw, eb in GHF_EDGES:
        vals = torch.from_numpy((erng.rand(eb, 2, 2, *ehw) * 256)
                                .astype(np.float32)).to(dev)
        emask = torch.from_numpy((erng.rand(*ehw) < 0.8).astype(np.uint8)) \
            .to(dev)
        for label, chain, dtype in GHF_KINDS:
            p = vals.to(getattr(torch, dtype))
            for off in (0, 1):
                buf = torch.empty(p.numel() + off, dtype=p.dtype, device=dev)
                q = buf[off:].view(p.shape)
                q.copy_(p)
                mbuf = torch.empty(emask.numel() + off, dtype=torch.uint8,
                                   device=dev)
                mq = mbuf[off:].view(ehw)
                mq.copy_(emask)
                for sm in (0, 1):
                    checks.append(case(chain, q, mq if sm else None, sm))
    return checks, times


#: SASS opcodes counted per kernel instance (static counts of the
#: compiled code: conversions to and from f64, f64 arithmetic, shared
#: loads, copies, TMA, shuffles)
SASS_OPS = ("F2F.F64.F32", "F2F.F32.F64", "DADD", "DMUL", "DFMA", "I2F",
            "LDS", "LDGSTS", "UTMALDG", "SHFL", "BAR")


def sass_counts(_build, lib_path):
    """{kernel instance: {opcode: static count}} of a built library, read
    with the toolkit's cuobjdump; {} where it is missing."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            # the template arguments of an instance: smooth, bytes, chain
            t = re.search(r"kernelILb(\d)ELi(\d)ELi(\d)E", name)
            name = (f"smooth {t.group(1)} in {t.group(2)} chain "
                    f"{t.group(3)}" if t else name[-40:])
            counts[name] = {op: 0 for op in SASS_OPS}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if name and m:
            op = m.group(1)
            for key in SASS_OPS:
                if op == key or op.startswith(key + "."):
                    counts[name][key] += 1
    return counts

def sweep_fpga_walk(_build, libs, dev, todo, failures, rows):
    """B5's and the walk's variants at config 5's shapes (and the walk's at
    VGA); returns the walk's host pairs (None without the walk)."""
    import torch
    import waldboost_tpu_torch as wt
    from chip_smoke import random_deep_stage
    from waldboost_tpu_torch.ops import cascade as gen_mod
    from waldboost_tpu_torch.ops import cascade_static as casc_mod
    from waldboost_tpu_torch.ops import fpga as fpga_mod
    pairs = None
    load = lambda n: wt.load(os.path.join(ROOT, "models", n + ".pb"),
                             device=dev)
    m5, m5s, synth = (load(n) for n in ("fpga_4k_synth_64",
                                        "fpga_4k_smooth_synth_64",
                                        "flagship_synth_64"))
    hw4k = (2160, 3840)
    det5 = wt.make_batched_detector_boxes(m5, hw4k, k=128, nms_iou=0.5,
                                          device=dev)[0]
    det5s = wt.make_batched_detector_boxes(m5s, hw4k, k=128, nms_iou=0.5,
                                           device=dev)[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    noise4k = torch.randint(0, 256, (BATCH,) + hw4k, generator=gen,
                            dtype=torch.uint8, device=dev)
    planes4k = det5.canvas.planes(det5.canvas.octaves(noise4k))

    if "fpga" in todo:
        checks, times = [], {}
        for d, sm in ((det5, 0), (det5s, 1)):
            cs = d.canvas
            args5 = (planes4k, cs.ring, cs.interior if sm else None,
                     cs.cf.fused_kind, sm)
            fn = (lambda a: lambda: [fpga_mod.fpga_channels(*a)])(args5)
            checks.append((fn, [fpga_mod.fpga_channels_plain(*args5)]))
            times[f"4K smooth {sm}"] = fn
        erng = np.random.RandomState(3)
        for ehw, eb in (((3, 5), 3), ((17, 45), 1), ((70, 257), 3)):
            buf = torch.from_numpy(erng.randint(
                0, 256, 4 * eb * ehw[0] * ehw[1] + 1).astype(np.uint8)).to(dev)
            eplanes = buf[1:].view((eb, 2, 2) + ehw)
            ering = torch.from_numpy((erng.rand(2, 2, *ehw) < 0.8)
                                     .astype(np.uint8)).to(dev)
            einner = torch.from_numpy((erng.rand(*ehw) < 0.9)
                                      .astype(np.uint8)).to(dev)
            for kind in ("grad_mag_u1", "grad_hist_4_u1",
                         "grad_hist_4_u1+grad_mag_u1"):
                for sm in (0, 1):
                    a = (eplanes, ering, einner if sm else None, kind, sm)
                    checks.append((
                        (lambda a: lambda: [fpga_mod.fpga_channels(*a)])(a),
                        [fpga_mod.fpga_channels_plain(*a)]))
        sweep(_build, "fpga", FPGA_VARIANTS, libs["fpga"], checks, times,
              failures, rows)

    if "walk" in todo:
        canvas5 = det5.canvas.channels(planes4k)
        detv = wt.make_batched_detector_boxes(synth, VGA, k=128, nms_iou=0.5,
                                              device=dev)[0]
        rng = np.random.RandomState(0)
        noise = torch.from_numpy(rng.randint(0, 256, (BATCH,) + VGA)
                                 .astype(np.uint8)).to(dev)
        canvasv = detv.canvas(noise)
        drng = np.random.RandomState(1)
        deep_stages, deep_theta = [], []
        for t in range(40):
            s = random_deep_stage(drng, (12, 12), 4, depth=5)
            s["threshold"] = drng.uniform(0, 300, len(s["threshold"])) \
                .astype(np.float32)
            deep_stages.append(s)
            deep_theta.append(-0.6 - 0.1 * t if t % 2 else -np.inf)
        deep = wt.model_from_stages(synth.shape, synth.channel_opts,
                                    deep_stages, deep_theta, device=dev)
        big_stages = [random_deep_stage(drng, (12, 12), 4, depth=5)
                      for _ in range(256)]
        for st in big_stages:
            st["threshold"] = drng.uniform(0, 300, len(st["threshold"])) \
                .astype(np.float32)
        big = wt.model_from_stages(synth.shape, synth.channel_opts,
                                   big_stages, [-np.inf] * 256, device=dev)
        ops5, opsv = det5.cascade_ops, detv.cascade_ops
        opsd, opsb = deep._operands(dev), big._operands(dev)
        ctabv = synth._get_cascade()[0]
        valid5, validv = det5.grid.valid, detv.grid.valid
        walks = {
            "B3 C=5": (lambda: casc_mod.cascade_masked(canvas5, valid5, ops5),
                       lambda: casc_mod.cascade_masked_plain(canvas5, valid5,
                                                             ops5)),
            "B4 C=5": (lambda: casc_mod.cascade_response(canvas5, valid5,
                                                         ops5),
                       lambda: casc_mod.cascade_response_plain(
                           canvas5, valid5, ops5)),
            "B3 VGA": (lambda: casc_mod.cascade_masked(canvasv, validv, opsv),
                       lambda: casc_mod.cascade_masked_plain(canvasv, validv,
                                                             opsv)),
            "B6 VGA": (lambda: gen_mod.cascade_response_grid(
                canvasv, ctabv, (12, 12), validv),
                       lambda: gen_mod.cascade_response_grid_plain(
                           canvasv, ctabv, (12, 12), validv)),
            "B3 VGA deep40": (
                lambda: casc_mod.cascade_masked(canvasv, validv, opsd),
                lambda: casc_mod.cascade_masked_plain(canvasv, validv, opsd)),
        }
        checks = [(fn, ref()) for fn, ref in walks.values()]
        checks.append((lambda: casc_mod.cascade_response(canvasv, validv,
                                                         opsd, 12),
                       casc_mod.cascade_response_plain(canvasv, validv, opsd,
                                                       12)))
        erng = np.random.RandomState(3)
        for ehw in ((12 + 3, 12 + 50), (12 + 40, 12 + 5), (12 + 19, 12 + 77)):
            ecv = torch.from_numpy(erng.uniform(0, 300, (3, 4) + ehw)
                                   .astype(np.float32)).to(dev)
            evalid = torch.from_numpy((erng.rand(ehw[0] - 12, ehw[1] - 12)
                                       < 0.8).astype(np.uint8)).to(dev)
            for eops in (opsd, opsb):
                a = (ecv, evalid, eops)
                checks.append(((lambda a: lambda: casc_mod.cascade_masked(
                    *a))(a), casc_mod.cascade_masked_plain(*a)))
                for cap in (0, 1, None):
                    checks.append(((lambda a, c: lambda: casc_mod
                                    .cascade_response(*a, c))(a, cap),
                                   casc_mod.cascade_response_plain(*a, cap)))
        times = {k: fn for k, (fn, _) in walks.items() if "deep" not in k}
        # host cost of one B4 launch where the card keeps up: one tile of
        # origins (the launch-bound Model-API calls)
        tiny = torch.from_numpy(erng.uniform(0, 300, (1, 4, 20, 44))
                                .astype(np.float32)).to(dev)
        tiny_valid = torch.ones((8, 32), dtype=torch.uint8, device=dev)
        host = {"B4 one-tile host": lambda: casc_mod.cascade_response(
            tiny, tiny_valid, opsv)}
        sweep(_build, "cascade", WALK_VARIANTS, libs["walk"], checks, times,
              failures, rows, host)
        pairs = host_pairs(_build, libs["walk"], "committed",
                           "device queries at every launch",
                           host["B4 one-tile host"])

        # the committed build on GENERAL records of the depth-2 models
        from chip_smoke import cuda_ms
        targets = ((ops5, tuple(canvas5.shape[1:])),
                   (opsv, tuple(canvasv.shape[1:])),
                   (ctabv, tuple(canvasv.shape[1:])))
        default = [t.records(s).layout for t, s in targets]
        heap2 = gen_mod._heap2
        gen_mod._heap2 = lambda tab: None
        try:
            for t, s in targets:
                t._records.pop(s)
                t.records(s)
        finally:
            gen_mod._heap2 = heap2
        layouts = [t.records(s).layout for t, s in targets]
        _build._LIBS["cascade"] = libs["walk"]["committed"][0]
        bad = sum(mismatches(check(), want) for check, want in checks[:4])
        ms = {k: timed(cuda_ms, fn) for k, fn in times.items()}
        for t, s in targets:
            t._records.pop(s)
        _build._LIBS.pop("cascade", None)
        label = (f"committed on GENERAL records (layouts {default} -> "
                 f"{layouts})")
        rows.append({"kernel": "cascade", "variant": label, "ms": ms,
                     "mismatches": bad, "ablation": False, "ptxas": ""})
        print(f"cascade {label}: " + ", ".join(
            f"{t} {v:.4f} ms" for t, v in ms.items()) + f"; mismatches {bad}",
            flush=True)
        if bad:
            failures.append("cascade GENERAL records")
    return pairs


def sweep_walk_fast(_build, libs, dev, failures, rows):
    """B3f's variants: every non-ablation row bitwise against the plain
    version over chip_smoke.py's B3f edge set and the VGA canvases of
    the three committed models (noise and scenes, batch 8), then timed on
    the VGA noise and scene canvases of flagship_synth_64 from a CUDA
    graph (chip_smoke.graph_ms: no host time)."""
    import torch
    import waldboost_tpu_torch as wt
    from chip_smoke import MODEL_NAMES, b3f_edges, graph_ms, scene_batch
    from waldboost_tpu_torch._build import launches
    from waldboost_tpu_torch.ops import cascade as gen_mod
    from waldboost_tpu_torch.ops import cascade_static as casc_mod
    defaults = {k: getattr(gen_mod, k) for k in
                ("FRONT_REJECTS", "FRONT_FOOTPRINT_BYTES")}
    models = {n: wt.load(os.path.join(ROOT, "models", n + ".pb"), device=dev)
              for n in MODEL_NAMES}
    det = wt.make_batched_detector_boxes(models["flagship_synth_64"], VGA,
                                         k=128, nms_iou=0.5, device=dev,
                                         fast=True)[0]
    rng = np.random.RandomState(0)
    noise = torch.from_numpy(rng.randint(0, 256, (BATCH,) + VGA)
                             .astype(np.uint8)).to(dev)
    canvases = {"noise": det.canvas(noise),
                "scene": det.canvas(scene_batch(BATCH).to(dev))}
    valid = det.grid.valid
    cases = list(b3f_edges(casc_mod, dev))
    for name, m in models.items():
        for cname, cv in canvases.items():
            cases.append((f"VGA {name} {cname}", cv, valid, m._operands(dev)))
    wants = [casc_mod.cascade_masked_plain(cv, v, o) for _, cv, v, o in cases]
    ops = models["flagship_synth_64"]._operands(dev)
    every_ops = {id(o): o for _, _, _, o in cases}.values()
    order = list(WALK_FAST_VARIANTS) + ["committed"]
    for i, label in enumerate(order):
        edits, ablation, host = WALK_FAST_VARIANTS[label]
        lib, ptx = libs[label]
        _build._LIBS["cascade_fast"] = lib
        for k, v in defaults.items():
            setattr(gen_mod, k, host.get(k, v))
        for o in every_ops:  # the front's records under these settings
            o._fronts.clear()
            o._fast_runs.clear()
        walk = casc_mod.cascade_masked
        before = dict(launches)
        bad = sum(mismatches(walk(cv, v, o), want)
                  for (_, cv, v, o), want in zip(cases, wants))
        paths = {p for p in casc_mod.FAST_PATHS
                 if launches["cascade_fast/" + p] != before.get(
                     "cascade_fast/" + p, 0)}
        ms = {k: graph_ms((lambda cv: lambda: walk(cv, valid, ops))(cv), 20)
              for k, cv in canvases.items()}
        tag = label if i < len(order) - 1 else label + " (again)"
        rows.append({"kernel": "cascade_fast", "variant": tag, "ms": ms,
                     "mismatches": bad, "ablation": ablation, "ptxas": ptx,
                     "paths": sorted(str(p) for p in paths)})
        print(f"cascade_fast {tag}: " + ", ".join(
            f"{t} {v:.4f} ms" for t, v in ms.items())
            + f"; mismatches {bad}" + (" (ablation)" if ablation else "")
            + f"; paths {sorted(str(p) for p in paths)}; ptxas {ptx}",
            flush=True)
        if bad and not ablation:
            failures.append(f"cascade_fast {label}")
    for k, v in defaults.items():
        setattr(gen_mod, k, v)
    _build._LIBS.pop("cascade_fast", None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="fpga,walk,walk_fast,planes,grad_hist",
                    help="comma-separated kernels: fpga, walk, walk_fast "
                    "(B3f), planes, grad_hist (B2, B2d, B2f), "
                    "grad_hist_float (B2d, B2f)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from chip_smoke import card_line
    from waldboost_tpu_torch import _build
    from waldboost_tpu_torch.ops import channels as tcc

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(card, flush=True)
    workdir = os.path.join(_build.BUILD_DIR, "sweep")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.time()
    todo = args.only.split(",")
    libs = {}
    if "planes" in todo:
        libs["planes"] = build_variants(_build, "planes", PLANES_VARIANTS,
                                        workdir)
    if "grad_hist" in todo:
        libs["grad_hist"] = build_variants(_build, "grad_hist", GH_VARIANTS,
                                           workdir)
    if "grad_hist" in todo or "grad_hist_float" in todo:
        libs["grad_hist_float"] = build_variants(
            _build, "grad_hist_float", GHF_VARIANTS, workdir)
    if "fpga" in todo:
        libs["fpga"] = build_variants(_build, "fpga", FPGA_VARIANTS, workdir)
    if "walk" in todo:
        libs["walk"] = build_variants(_build, "cascade", WALK_VARIANTS,
                                      workdir)
    if "walk_fast" in todo:
        libs["walk_fast"] = build_variants(_build, "cascade_fast",
                                           WALK_FAST_VARIANTS, workdir)
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    rows, failures = [], []
    if "planes" in todo:
        sweep_planes(_build, libs["planes"], dev, failures, rows)
    if "grad_hist" in todo:
        checks, times = grad_hist_cases(dev)
        tiny = torch.zeros((1, 2, 2, 8, 8), dtype=torch.uint8, device=dev)
        host = {"8x8 host": lambda: tcc.grad_hist(tiny, None, 0)}
        sweep(_build, "grad_hist", GH_VARIANTS, libs["grad_hist"], checks,
              times, failures, rows, host)
    sass = {}
    if "grad_hist_float" in libs:
        sass["committed"] = sass_counts(
            _build, libs["grad_hist_float"]["committed"][0]._name)
        for inst, ops in sass["committed"].items():
            print(f"sass committed, {inst}: " + ", ".join(
                f"{k} {v}" for k, v in ops.items()), flush=True)
        checks, times = grad_hist_float_cases(dev)
        tiny = torch.zeros((1, 2, 2, 8, 8), dtype=torch.float32, device=dev)
        host = {"8x8 host": lambda: tcc.grad_hist_float(tiny, None, 0)}
        sweep(_build, "grad_hist_float", GHF_VARIANTS,
              libs["grad_hist_float"], checks, times, failures, rows, host)
    pairs = None
    if "fpga" in todo or "walk" in todo:
        pairs = sweep_fpga_walk(_build, libs, dev, todo, failures, rows)
    if "walk_fast" in todo:
        sweep_walk_fast(_build, libs["walk_fast"], dev, failures, rows)
    shutil.rmtree(workdir, ignore_errors=True)
    summary = {"card": card, "rows": rows, "failures": failures}
    if sass:
        summary["sass"] = sass
    if pairs is not None:
        summary["host_pairs"] = pairs
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    if failures:
        print(f"FAILED: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
