// WaldBoost cascades with SPRT rejection over every window origin of the
// channel canvas.  One per-window walk serves three kernels through two C
// entry points:
//
//  wb_cascade          (B3) masked score map, survivor count and n_weak
//    over a float32 canvas (fast serving mode's bfloat16 canvas takes B3f,
//    csrc/cascade_fast.cu).
//    Replaces: waldboost_tpu/ops/cascade_static.py::
//    cascade_masked_grid_static (_make_static_kernel(masked_out=True)).
//  wb_cascade_response (B4) unmasked hs, alive and n_weak of a frozen
//    cascade over its first n_run stages (n_stages_cap).
//    Replaces: waldboost_tpu/ops/cascade_static.py::
//    cascade_response_grid_static (_make_static_kernel, unmasked kernel).
//  wb_cascade_response (B6) the same over the runtime tables of
//    cascade_from_stages: complete-heap or general trees, stages padded to
//    a bucket; n_weak counts only stages whose `active` flag is set.
//    Replaces: waldboost_tpu/ops/cascade_pallas.py::
//    cascade_response_grid_pallas (_make_kernel).
//  wb_cascade_suffix   (S1) stages [start, T) over a list of window
//    origins (two-phase serving's compacted prefix survivors), from their
//    prefix scores and alive flags; n_weak per image.  A warp an entry,
//    a lane a stage (see the note above suffix_kernel).
//    Replaces the XLA op waldboost_tpu/ops/cascade.py::
//    cascade_suffix_sparse (gathers of the compacted list, stage by
//    stage); JAX has no kernel here.
//
// The TPU kernels exit per tile: B3/B4 every 8 stages with the cascade
// baked into the program, B6 per stage through SMEM switch chains.  Here
// each window exits on its own, which is exact because rejection is
// monotone: a window rejected at stage t keeps the hs it had after stage t
// (the TPU kernels add alive*resp = 0 from then on), and n_weak counts the
// stages a window entered alive.
//
// The canvas is float32 or, for B4 and S1 in fast serving mode, bfloat16:
// each canvas load widens its value to f32 exactly, so a bfloat16 canvas
// gives the results of its float32 copy.
//
// Bound on the H100: the canvas read once and the outputs written once;
// but a window's work is a chain of dependent loads (node, feature value,
// child) over the stages it enters, so the walk is bound by latency and by
// warps that wait for their last window.
//
// Design.  The host packs the tables once per canvas shape (ops/cascade.py
// ::node_records), feature positions as canvas offsets fch*H*W + fr*W + fc
// and floats as their bits.  Cascades of trees at most 2 deep (every
// committed model) take the HEAP2 layout: per stage one 48-byte record of
// the complete depth-2 heap {off0, thr0, off1, thr1, off2, thr2, theta,
// counts, the four leaves}, 3 KB for 64 stages; a stage is three canvas
// loads issued together.  Deeper trees take the GENERAL layout: per stage
// {theta, counts}, then per node a 16-byte record {offset, threshold, left
// | right << 16 (-1 at a leaf), leaf value}; the walk loads a node's and
// both its children's canvas values together.  (On the H100, GENERAL
// records of depth-2 trees and loading the next stage ahead of this
// stage's compares were both slower: scripts/sweep_torch_kernels.py.)  A
// block stages the table in shared memory with cp.async when it fits
// kSmemTables, else the same code reads it from global memory.
//
// Blocks are persistent (as many as fit the card) and take 8 x 32 tiles of
// origins, one row per warp (no division per thread; the rows of a tile
// share canvas lines in the SM's L1), in runs of kChunk adjacent tiles, so
// the survivors a warp queues lie in neighbouring columns.  Each warp walks
// its windows through a pass of stages that ends after kRejects stages
// that can reject (finite theta: a pass of a fixed count of stages rarely
// ends where windows die in cascades that reject every few stages) and
// pushes the survivors (origin, hs, next stage) onto its own shared-memory
// queue with ballot and popc; once the queue holds 32 it takes a pass of
// them, so the long walks run on full warps, and no warp waits for another
// (no block barrier after the table staging).
//
// hs sums leaf values in f32 in stage order from 0 (__fadd_rn; the library
// is built with -fmad=false); a stage rejects when !(hs >= theta): B3 and
// B4 get -inf for a non-finite theta from the host, B6 gets theta as the
// tables hold it (padding: -inf).  Per-image counts: each lane sums over
// the windows it walked, a warp shuffle reduce and one atomicAdd per warp
// when its tiles move to the next image (a queued survivor of an earlier
// image adds its own) into zeroed int32 outputs.  Child indices lie above
// their parent (checked on the host), so every tree walk ends within NN
// steps.

#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTR = 8, kTC = 32;        // tile of origins: rows x columns
constexpr int kBlock = kTR * kTC;       // one warp per tile row
constexpr int kRejects = 4;             // rejecting stages per pass
constexpr int kQueue = 64;              // survivors one warp can hold
constexpr int kChunk = 4;               // adjacent tiles a block takes in turn
constexpr int kSmemTables = 40 * 1024;  // most table bytes staged per block
constexpr int kLayoutHeap2 = 1;         // ops/cascade.py HEAP2 (else GENERAL)

struct Args {
  const void* canvas;  // float32, or bfloat16 (template parameter E)
  int batch, C, H, W;
  const uint8_t* valid;
  int gu, gv;
  const int* table;  // node records (ops/cascade.py::node_records)
  int table_bytes, T, n_run, NN;
  float* out0;
  uint8_t* alive_out;
  int* count;
  int* n_weak;
};

// A canvas value as f32: float32 as it is, bfloat16 widened exactly.
__device__ __forceinline__ float load(const float* __restrict__ w, int off) {
  return __ldg(w + off);
}
__device__ __forceinline__ float load(const __nv_bfloat16* __restrict__ w,
                                      int off) {
  return __uint_as_float(
      static_cast<uint32_t>(
          __ldg(reinterpret_cast<const unsigned short*>(w) + off))
      << 16);
}

template <class E>
__device__ __forceinline__ float value(const E* __restrict__ w,
                                       const int4& n) {
  return n.z >= 0 ? load(w, n.x) : 0.0f;
}

// The leaf value of one stage tree for the window at w, from its root n
// and the root's canvas value v: a node's children and their canvas values
// are loaded together, before the node's compare picks one.
template <class E>
__device__ __forceinline__ float walk(const int4* rec,
                                      const E* __restrict__ w, int4 n,
                                      float v) {
  while (n.z >= 0) {
    const int4 a = rec[n.z & 0xffff], b = rec[n.z >> 16];
    const float va = value(w, a), vb = value(w, b);
    const bool go_left = v <= __int_as_float(n.y);
    const int4 c = go_left ? a : b;
    if (c.z < 0) return __int_as_float(c.w);
    const float vc = go_left ? va : vb;
    n = rec[vc <= __int_as_float(c.y) ? (c.z & 0xffff) : (c.z >> 16)];
    v = value(w, n);
  }
  return __int_as_float(n.w);
}

// A stage of the HEAP2 layout: a = {off0, thr0, off1, thr1}, q = {off2,
// thr2, theta, counts}, p = the leaves 3..6; v0..v2 the canvas values of
// nodes 0..2, loaded together.
struct Heap2 {
  int4 a, q;
  float4 p;
  float v0, v1, v2;
};

template <class E>
__device__ __forceinline__ Heap2 fetch(const int4* s, int t,
                                       const E* __restrict__ w) {
  Heap2 h;
  h.a = s[3 * t];
  h.q = s[3 * t + 1];
  const int4 p = s[3 * t + 2];
  h.p = make_float4(__int_as_float(p.x), __int_as_float(p.y),
                    __int_as_float(p.z), __int_as_float(p.w));
  h.v0 = load(w, h.a.x);
  h.v1 = load(w, h.a.z);
  h.v2 = load(w, h.q.x);
  return h;
}

__device__ __forceinline__ float leaf(const Heap2& h) {
  return h.v0 <= __int_as_float(h.a.y)
             ? (h.v1 <= __int_as_float(h.a.w) ? h.p.x : h.p.y)
             : (h.v2 <= __int_as_float(h.q.y) ? h.p.z : h.p.w);
}

// One warp's sums for image b: a shuffle reduce and one atomicAdd each.
__device__ __forceinline__ void flush(int& nw, int& cnt, int b,
                                      const Args& a, bool masked) {
  for (int off = 16; off > 0; off >>= 1) {
    if (masked) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    nw += __shfl_down_sync(0xffffffffu, nw, off);
  }
  if ((threadIdx.x & 31) == 0 && b >= 0) {
    if (masked && cnt) atomicAdd(a.count + b, cnt);
    if (nw) atomicAdd(a.n_weak + b, nw);
  }
  nw = 0;
  cnt = 0;
}

// kMasked: out0 = masked map (hs where alive, -inf elsewhere), count per
// image.  Otherwise out0 = hs, alive_out = alive (0/1 bytes).  kStaged:
// the table is copied to shared memory first.  kHeap2: the HEAP2 layout.
// E: the canvas element (float or __nv_bfloat16).
template <bool kMasked, bool kStaged, bool kHeap2, class E>
__global__ void __launch_bounds__(kBlock) cascade_kernel(Args a) {
  extern __shared__ int4 s_table[];
  __shared__ int q_out[kTR][kQueue];    // output index r * gv + c
  __shared__ int q_cv[kTR][kQueue];     // canvas index r * W + c
  __shared__ int q_bt[kTR][kQueue];     // image << 16 | next stage
  __shared__ float q_hs[kTR][kQueue];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kStaged) {
    const char* src = reinterpret_cast<const char*>(a.table);
    for (int i = threadIdx.x; i < a.table_bytes / 16; i += kBlock) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(s_table + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src + 16 * static_cast<size_t>(i)));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  const int* tab = kStaged ? reinterpret_cast<const int*>(s_table) : a.table;
  const int2* stage = reinterpret_cast<const int2*>(tab);
  const int4* recs = reinterpret_cast<const int4*>(tab + 2 * ((a.T + 1) & ~1));

  const int tiles_c = (a.gv + kTC - 1) / kTC;
  const int tiles_img = ((a.gu + kTR - 1) / kTR) * tiles_c;
  const int n_tiles = a.batch * tiles_img;
  const size_t img = static_cast<size_t>(a.C) * a.H * a.W;
  int* qo = q_out[warp];
  int* qc = q_cv[warp];
  int* qb = q_bt[warp];
  float* qh = q_hs[warp];
  int qn = 0;                   // entries in this warp's queue
  int nw = 0, cnt = 0, wb = -1;  // this lane's sums for image wb
  // runs of kChunk adjacent tiles, gridDim.x runs apart: this warp takes
  // row `warp` of each tile
  int tile = blockIdx.x * kChunk;
  for (;;) {
    // a pass: 32 queued survivors when the queue holds them (or the last
    // ones once the tiles are done), else the next tile row of origins
    int out = 0, cv = 0, b = 0, t0 = 0;
    float hs = 0.0f;
    bool have;
    if (qn >= 32 || (tile >= n_tiles && qn > 0)) {
      const int take = min(qn, 32);
      qn -= take;
      have = lane < take;
      if (have) {
        out = qo[qn + lane];
        cv = qc[qn + lane];
        b = qb[qn + lane] >> 16;
        t0 = qb[qn + lane] & 0xffff;
        hs = qh[qn + lane];
      }
      __syncwarp();
    } else if (tile < n_tiles) {
      b = tile / tiles_img;
      const int rest = tile - b * tiles_img, tr = rest / tiles_c;
      const int r = tr * kTR + warp, c = (rest - tr * tiles_c) * kTC + lane;
      if (++tile % kChunk == 0) tile += (gridDim.x - 1) * kChunk;
      if (b != wb) {
        flush(nw, cnt, wb, a, kMasked);
        wb = b;
      }
      const bool inside = r < a.gu && c < a.gv;
      out = r * a.gv + c;
      cv = r * a.W + c;
      have = inside && a.valid[out] != 0;
      if (inside && !have) {
        const size_t o = static_cast<size_t>(b) * a.gu * a.gv + out;
        if (kMasked) {
          a.out0[o] = -INFINITY;
        } else {
          a.out0[o] = 0.0f;
          a.alive_out[o] = 0;
        }
      }
    } else {
      break;
    }

    int t = t0;  // the next stage this window walks
    bool keep = false;
    if (have) {
      const E* w = static_cast<const E*>(a.canvas) + b * img + cv;
      bool alive = true;
      int my_nw = 0, rej = 0;
      if (kHeap2) {
        // each stage's three features loaded together
        const int4* s = reinterpret_cast<const int4*>(tab);
        while (t < a.n_run) {
          const Heap2 h = fetch(s, t, w);
          const float theta = __int_as_float(h.q.z);
          my_nw += h.q.w;
          hs = __fadd_rn(hs, leaf(h));
          ++t;
          if (!(hs >= theta)) {
            alive = false;
            break;
          }
          if (theta != -INFINITY && ++rej == kRejects) break;
        }
      } else {
        while (t < a.n_run) {
          const int4 n = recs[t * a.NN];
          const int2 st = stage[t];
          const float theta = __int_as_float(st.x);
          my_nw += st.y;
          hs = __fadd_rn(hs, walk(recs + t * a.NN, w, n, value(w, n)));
          ++t;
          if (!(hs >= theta)) {
            alive = false;
            break;
          }
          if (theta != -INFINITY && ++rej == kRejects) break;
        }
      }
      keep = alive && t < a.n_run;
      const int my_cnt = kMasked && !keep && alive;
      if (b == wb) {
        nw += my_nw;
        cnt += my_cnt;
      } else {  // a survivor of an earlier image: rare
        if (my_nw) atomicAdd(a.n_weak + b, my_nw);
        if (my_cnt) atomicAdd(a.count + b, my_cnt);
      }
      if (!keep) {
        const size_t o = static_cast<size_t>(b) * a.gu * a.gv + out;
        if (kMasked) {
          a.out0[o] = alive ? hs : -INFINITY;
        } else {
          a.out0[o] = hs;
          a.alive_out[o] = static_cast<uint8_t>(alive);
        }
      }
    }
    // queue the survivors (the queue never exceeds 63 entries: it takes
    // at most 32 new ones while it holds fewer than 32)
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int at = qn + __popc(mask & ((1u << lane) - 1u));
      qo[at] = out;
      qc[at] = cv;
      qb[at] = b << 16 | t;
      qh[at] = hs;
    }
    qn += __popc(mask);
    __syncwarp();
  }
  flush(nw, cnt, wb, a, kMasked);
}

// Blocks of one instance that fit the card at once: queried once per
// device and shared-memory size, so the host-bound paths pay no device
// queries per launch.
template <bool kMasked, bool kStaged, bool kHeap2, class E>
long long resident_blocks(int smem) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, long long> fit;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  const auto it = fit.find(key);
  if (it != fit.end()) return it->second;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cascade_kernel<kMasked, kStaged, kHeap2, E>, kBlock, smem);
  return fit[key] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

template <bool kMasked, bool kStaged, bool kHeap2, class E>
void launch_grid(const Args& a, cudaStream_t stream) {
  const int smem = kStaged ? a.table_bytes : 0;
  const long long n_tiles = static_cast<long long>(a.batch) *
                            ((a.gu + kTR - 1) / kTR) *
                            ((a.gv + kTC - 1) / kTC);
  const long long n_runs = (n_tiles + kChunk - 1) / kChunk;
  const long long fit = resident_blocks<kMasked, kStaged, kHeap2, E>(smem);
  cascade_kernel<kMasked, kStaged, kHeap2, E>
      <<<static_cast<int>(n_runs < fit ? n_runs : fit), kBlock, smem,
         stream>>>(a);
}

template <bool kMasked, bool kHeap2, class E>
void launch_layout(const Args& a, cudaStream_t stream) {
  if (a.table_bytes <= kSmemTables)
    launch_grid<kMasked, true, kHeap2, E>(a, stream);
  else
    launch_grid<kMasked, false, kHeap2, E>(a, stream);
}

template <bool kMasked, class E>
int launch_typed(const Args& a, int layout, void* stream) {
  // a queue entry packs image << 16 | stage
  if (a.batch >= (1 << 15) || a.T >= (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch > 0 && a.gu > 0 && a.gv > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (layout == kLayoutHeap2)
      launch_layout<kMasked, true, E>(a, st);
    else
      launch_layout<kMasked, false, E>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// canvas_bytes: 4 float32, 2 bfloat16 (the unmasked walk alone).
template <bool kMasked>
int launch(const Args& a, int canvas_bytes, int layout, void* stream) {
  if (canvas_bytes == 4) return launch_typed<kMasked, float>(a, layout, stream);
  if constexpr (!kMasked) {
    if (canvas_bytes == 2)
      return launch_typed<false, __nv_bfloat16>(a, layout, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Args args(const void* canvas, int batch, int C, int H, int W,
          const void* valid, int gu, int gv, const void* table,
          int table_bytes, int T, int n_run, int NN, void* out0,
          void* alive_out, void* count, void* n_weak) {
  return Args{canvas,
              batch, C, H, W,
              static_cast<const uint8_t*>(valid),
              gu, gv,
              static_cast<const int*>(table),
              table_bytes, T, n_run, NN,
              static_cast<float*>(out0),
              static_cast<uint8_t*>(alive_out),
              static_cast<int*>(count),
              static_cast<int*>(n_weak)};
}

// S1: stage-parallel warp walk.  Stage t's response depends on the
// canvas and stage t alone, not on the running score, so a warp walks
// one entry at a time with a lane for each of 32 consecutive stages:
// the lanes fetch their stage's records, canvas values and leaf together
// (one latency for 32 stages, where a thread an entry paid one a stage),
// then every lane adds the 32 leaves, passed by shuffles, in stage order
// with __fadd_rn and tests each stage's theta: the f32 additions of the
// serial walk, so hs and alive are bitwise its.  A rejection ends the
// entry; n_weak adds the counting stages it entered (a ballot), one
// atomicAdd an entry.  The blocks are persistent and warp w takes
// entries w, w + W, ... of the flattened (B, S) list 32 at a time (a lane
// each): the dead ones (after S2 a suffix of each row) are written by
// their lanes at once, the alive ones walked in turn, so the alive
// entries at the head of each row spread over every warp of the card.
// Bound: the canvas values a stage needs sit behind its record's load,
// and the stage chain is serial in f32: latency, not bytes.
struct SuffixArgs {
  const void* canvas;  // (B, C, H, W) float32 or bfloat16
  int C, H, W, gv;     // gv: the width of the grid idx indexes
  const long long* idx;  // (B, S) origins r * gv + c
  const float* h_in;     // (B, S) prefix scores
  const uint8_t* alive_in;
  int S;
  const int* table;  // node records (ops/cascade.py::node_records)
  int T, start, NN;
  float* h_out;
  uint8_t* alive_out;
  int* n_weak;  // (B,), zeroed by the caller
};

constexpr int kSuffixBlock = 256;

// One lane's stage t of the entry at w: its leaf value, theta and whether
// it counts toward n_weak.
template <bool kHeap2, class E>
__device__ __forceinline__ void suffix_stage(const SuffixArgs& a, int t,
                                             const E* __restrict__ w,
                                             float& resp, float& theta,
                                             int& counts) {
  if (kHeap2) {
    const Heap2 h = fetch(reinterpret_cast<const int4*>(a.table), t, w);
    resp = leaf(h);
    theta = __int_as_float(h.q.z);
    counts = h.q.w;
  } else {
    const int2 st = reinterpret_cast<const int2*>(a.table)[t];
    const int4* recs =
        reinterpret_cast<const int4*>(a.table + 2 * ((a.T + 1) & ~1)) +
        static_cast<size_t>(t) * a.NN;
    const int4 n = recs[0];
    resp = walk(recs, w, n, value(w, n));
    theta = __int_as_float(st.x);
    counts = st.y;
  }
}

template <bool kHeap2, class E>
__global__ void __launch_bounds__(kSuffixBlock)
    suffix_kernel(SuffixArgs a, long long total) {
  const int lane = threadIdx.x & 31;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * (kSuffixBlock / 32);
  const long long warp =
      static_cast<long long>(blockIdx.x) * (kSuffixBlock / 32) +
      (threadIdx.x >> 5);
  const size_t img = static_cast<size_t>(a.C) * a.H * a.W;
  for (long long first = warp; first < total; first += 32 * n_warps) {
    const long long i = first + lane * n_warps;
    float h = 0.0f;
    bool walk_it = false;
    if (i < total) {
      h = a.h_in[i];
      const bool alive = a.alive_in[i] != 0;
      walk_it = alive && a.start < a.T;
      if (!walk_it) {  // dead, or no stage left: the input as it is
        a.h_out[i] = h;
        a.alive_out[i] = static_cast<uint8_t>(alive);
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, walk_it);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long j = first + src * n_warps;
      float hs = __shfl_sync(0xffffffffu, h, src);
      const int b = static_cast<int>(j / a.S);
      const long long o = a.idx[j];
      const long long r = o / a.gv, c = o - r * a.gv;
      const E* w = static_cast<const E*>(a.canvas) + b * img + r * a.W + c;
      bool alive = true;
      int nw = 0;
      for (int t0 = a.start; t0 < a.T && alive; t0 += 32) {
        const int n_here = min(32, a.T - t0);
        float resp = 0.0f, theta = 0.0f;
        int counts = 0;
        if (lane < n_here)
          suffix_stage<kHeap2, E>(a, t0 + lane, w, resp, theta, counts);
        int rej = 32;  // the first stage of the 32 that rejects
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          const float v = __shfl_sync(0xffffffffu, resp, s);
          const float th = __shfl_sync(0xffffffffu, theta, s);
          if (s < n_here && rej == 32) {
            hs = __fadd_rn(hs, v);
            if (!(hs >= th)) rej = s;
          }
        }
        nw += __popc(__ballot_sync(0xffffffffu, counts && lane <= rej &&
                                                    lane < n_here));
        alive = rej == 32;
      }
      if (lane == 0) {
        a.h_out[j] = hs;
        a.alive_out[j] = static_cast<uint8_t>(alive);
        if (nw) atomicAdd(a.n_weak + b, nw);
      }
    }
  }
}

// Blocks of an S1 instance that fit the card at once (queried once per
// device).
template <bool kHeap2, class E>
long long suffix_blocks() {
  static std::mutex mu;
  static std::map<int, long long> fit;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = fit.find(dev);
  if (it != fit.end()) return it->second;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, suffix_kernel<kHeap2, E>, kSuffixBlock, 0);
  return fit[dev] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

template <bool kHeap2, class E>
void launch_suffix(const SuffixArgs& a, int batch, cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * a.S;
  // at least one entry a warp
  const long long want = (total + kSuffixBlock / 32 - 1) / (kSuffixBlock / 32);
  const long long fit = suffix_blocks<kHeap2, E>();
  suffix_kernel<kHeap2, E>
      <<<static_cast<int>(want < fit ? want : fit), kSuffixBlock, 0,
         stream>>>(a, total);
}

}  // namespace

// S1: stages [start, T) of the (B, S) list entries over a float32
// (canvas_bytes 4) or bfloat16 (2) canvas: h_out, alive_out and n_weak
// (zeroed by the caller).
extern "C" int wb_cascade_suffix(const void* canvas, int canvas_bytes,
                                 int batch, int C, int H, int W, int gv,
                                 const void* idx, const void* h_in,
                                 const void* alive_in, int S,
                                 const void* table, int layout, int T,
                                 int start, int NN, void* h_out,
                                 void* alive_out, void* n_weak,
                                 void* stream) {
  if (batch >= 65536 || gv <= 0 || start < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SuffixArgs a{canvas, C, H, W, gv,
                     static_cast<const long long*>(idx),
                     static_cast<const float*>(h_in),
                     static_cast<const uint8_t*>(alive_in), S,
                     static_cast<const int*>(table), T, start, NN,
                     static_cast<float*>(h_out),
                     static_cast<uint8_t*>(alive_out),
                     static_cast<int*>(n_weak)};
  if (batch > 0 && S > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool heap2 = layout == kLayoutHeap2;
    if (canvas_bytes == 4) {
      heap2 ? launch_suffix<true, float>(a, batch, st)
            : launch_suffix<false, float>(a, batch, st);
    } else if (canvas_bytes == 2) {
      heap2 ? launch_suffix<true, __nv_bfloat16>(a, batch, st)
            : launch_suffix<false, __nv_bfloat16>(a, batch, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// B3: masked map, survivor count and n_weak over all T stages (count,
// n_weak zeroed by the caller) of a float32 canvas (canvas_bytes 4; any
// other is refused).
extern "C" int wb_cascade(const void* canvas, int canvas_bytes, int batch,
                          int C, int H, int W,
                          const void* valid, int gu, int gv,
                          const void* table, int table_bytes, int layout,
                          int T, int n_run, int NN, void* masked, void* count,
                          void* n_weak, void* stream) {
  return launch<true>(args(canvas, batch, C, H, W, valid, gu, gv, table,
                           table_bytes, T, n_run, NN, masked, nullptr, count,
                           n_weak),
                      canvas_bytes, layout, stream);
}

// B4 and B6: hs, alive and n_weak over the first n_run stages (n_weak
// zeroed by the caller) of a float32 (canvas_bytes 4) or bfloat16 (2)
// canvas.
extern "C" int wb_cascade_response(const void* canvas, int canvas_bytes,
                                   int batch, int C, int H, int W,
                                   const void* valid, int gu,
                                   int gv, const void* table,
                                   int table_bytes, int layout, int T,
                                   int n_run, int NN, void* hs, void* alive,
                                   void* n_weak, void* stream) {
  return launch<false>(args(canvas, batch, C, H, W, valid, gu, gv, table,
                            table_bytes, T, n_run, NN, hs, alive, nullptr,
                            n_weak),
                       canvas_bytes, layout, stream);
}
