// B3f: the masked SPRT walk over a bfloat16 channel canvas (fast serving
// mode): the masked score map (hs where the window survived, -inf
// elsewhere), the per-image survivor count and n_weak, the values of B3
// (csrc/cascade.cu, wb_cascade) over the canvas's float32 copy.
//
//  wb_cascade_fast (B3f)
//    Replaces: waldboost_tpu/ops/cascade_static.py::
//    cascade_masked_grid_static with fast=True (_make_static_kernel over
//    bfloat16 tiles, each value widened to f32 at its read).
//
// Bound on the H100: bytes (the canvas read once, the map written once).
// On noise 89% of the valid windows die at stage 0 and a window enters
// 1.2 stages on average (2.2-2.5 on scenes), so the walk is mostly one
// dense stencil: stage 0's three features at fixed offsets from every
// origin.  The per-window walk of csrc/cascade.cu pays its whole
// machinery (tile decode, a byte of the mask, the stage record, three
// 2-byte canvas loads, a scalar store, queue bookkeeping) for that one
// stage, in a chain of dependent loads.
//
// Design: a dense front, then the sparse walk for the few survivors.
//
// Front.  Persistent blocks (one wave) each take a contiguous run of tiles
// of kTR x kTC origins, images slowest, so a warp's queued survivors belong
// to the image it is in (tiles taken the grid's width apart put nearly
// every survivor in an earlier image, whose n_weak and count then took
// per-lane atomics on 8 addresses: 1.7x slower).  A producer warp fills a
// ring of kBufs buffers with the tiles' footprints, C x (kTR + m - 1) x FW
// bfloat16 (FW: kTC + n - 1 rounded up to 16 bytes), each by one TMA box
// copy (cp.async.bulk.tensor.3d over the canvas as a (B*C, H, W) tensor,
// zero fill off it) completing on the buffer's `full` mbarrier; each
// consumer warp arrives on its `empty` mbarrier once it has read the
// footprint, so no warp waits for another's walk.  Where the canvas rows or
// base do not lie on 16 bytes, or a footprint exceeds the host's budget,
// the host builds the front's records in the canvas's strides and the
// front reads the canvas from global memory (__ldg) in the same kernel.
// Each consumer thread owns kP adjacent origins of one row; the front's
// stages (stage 0 through the host's first FRONT_REJECTS stages that can
// reject, every stage when fewer can) are HEAP2 records whose feature
// offsets are in the staged tile's strides (fch*FH*FW + fr*FW + fc;
// ops/cascade.py::front_records), so a feature's kP values are one run of
// shared memory: two aligned vector loads and a warp-uniform word shift.
// Each value is widened to f32 exactly by a 16-bit shift; compares `v <=
// thr` in f32; hs sums leaves with __fadd_rn in stage order from 0 (the
// library is built with -fmad=false); a window dies when !(hs >= theta).
// The mask is read as one vector of kP bytes and the kP results stored as
// one vector where the rows allow (dead and invalid origins -inf; queued
// ones -inf until the walk writes them).
//
// Walk.  The front's survivors go onto their warp's shared-memory queue
// as (origin, hs, next stage), one origin of each thread at a time, with
// ballot and popc; whenever a queue holds 32 its warp takes a pass of
// them, and after its last tile the rest: csrc/cascade.cu's walk (HEAP2 or
// GENERAL records in canvas strides, staged in shared memory when they fit
// kSmemTables, the canvas through __ldg), each pass ending after kRejects
// rejecting stages and putting its survivors back; HEAP2 stages load the
// features of kAhead stages together (a stage's offsets do not depend on
// the walk).  n_weak and the count are summed per lane, then one shuffle
// reduce and one atomicAdd a warp when the tiles move to the next image (a
// queued survivor of an earlier image adds its own).
//
// Measured (scripts/sweep_torch_kernels.py --only walk_fast, VGA batch 8
// of flagship_synth_64, NVIDIA H100 80GB HBM3 at 700 W): the front alone
// takes about 0.9 of the whole kernel's time on noise; the rest is the
// walk of the windows that survive it (0.6% of them on noise), bound by
// the latency of its dependent stages, most of it in the walks that finish
// after a warp's last tile.

#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kTR = 16, kTC = 64;  // tile of origins: rows x columns
constexpr int kP = 4;              // adjacent origins a thread
constexpr int kBufs = 2;           // staged footprints
constexpr int kThreads = kTR * kTC / kP;
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = kTC / kP;  // threads a tile row
constexpr int kRejects = 4;            // rejecting stages a walk pass
constexpr int kAhead = 4;              // HEAP2 stages whose values a walk
                                       // loads together
constexpr int kQueue = 64;             // survivors one warp can hold
constexpr int kSmemTables = 40 * 1024;  // most walk-record bytes staged
constexpr int kLayoutHeap2 = 1;         // ops/cascade.py HEAP2 (else GENERAL)
static_assert(kP == 1 || kP == 2 || kP == 4 || kP == 8, "kP: 1, 2, 4, 8");
static_assert(kTC % kP == 0 && kThreads % 32 == 0 && kThreads <= 1024,
              "a tile must give whole warps");

// The front: its footprint staged in shared memory by TMA, read from
// global memory, or none (no stage of depth <= 2 to run densely).
constexpr int kFrontNone = 0, kFrontTile = 1, kFrontGlobal = 2;

struct Args {
  const uint16_t* canvas;  // bfloat16 bits
  int batch, C, H, W;
  const uint8_t* valid;
  int gu, gv;
  const int* table;  // walk records (ops/cascade.py::node_records)
  int table_bytes, T, NN;
  const int* front;  // the front's HEAP2 records (ops/cascade.py::
  int F;             //   front_records), F stages
  int fh, fw;        // footprint rows and row pitch (elements)
  int fbytes;        // bytes of one staged footprint buffer
  float* out;
  int* count;
  int* n_weak;
  int tiles_c, tiles_img, n_tiles;
  bool vec_valid;  // the mask read as kP-byte vectors
  bool vec_out;    // the map stored as kP-float vectors
};

// A canvas value (bfloat16 bits) as f32, exactly.
__device__ __forceinline__ float widen(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}
__device__ __forceinline__ float load(const uint16_t* __restrict__ w,
                                      int off) {
  return widen(__ldg(w + off));
}

// ---- the walk (csrc/cascade.cu's, over bfloat16) -------------------------

__device__ __forceinline__ float value(const uint16_t* __restrict__ w,
                                       const int4& n) {
  return n.z >= 0 ? load(w, n.x) : 0.0f;
}

// The leaf value of one stage tree for the window at w, from its root n
// and the root's canvas value v: a node's children and their canvas values
// are loaded together, before the node's compare picks one.
__device__ __forceinline__ float walk(const int4* rec,
                                      const uint16_t* __restrict__ w, int4 n,
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
// thr2, theta, counts}, p = the leaves 3..6.
__device__ __forceinline__ float leaf(const int4& a, const int4& q,
                                      const int4& p, float v0, float v1,
                                      float v2) {
  return v0 <= __int_as_float(a.y)
             ? (v1 <= __int_as_float(a.w) ? __int_as_float(p.x)
                                          : __int_as_float(p.y))
             : (v2 <= __int_as_float(q.y) ? __int_as_float(p.z)
                                          : __int_as_float(p.w));
}

// One warp's sums for image b: a shuffle reduce and one atomicAdd each.
__device__ __forceinline__ void flush(int& nw, int& cnt, int b,
                                      const Args& a) {
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    nw += __shfl_down_sync(0xffffffffu, nw, off);
  }
  if ((threadIdx.x & 31) == 0 && b >= 0) {
    if (cnt) atomicAdd(a.count + b, cnt);
    if (nw) atomicAdd(a.n_weak + b, nw);
  }
  nw = 0;
  cnt = 0;
}

// One warp's queue of survivors in shared memory.
struct Queue {
  int* out;    // map index r * gv + c
  int* cv;     // canvas index r * W + c
  int* bt;     // image << 16 | next stage
  float* hs;
  int n;       // entries
};

// A pass of the walk over up to 32 queued windows; the survivors after
// kRejects rejecting stages go back on the queue (it never exceeds 63
// entries: it takes at most 32 new ones while it holds fewer than 32).
template <bool kHeap2>
__device__ __forceinline__ void pass(Queue& q, const int* tab, const Args& a,
                                     int wb, int& nw, int& cnt) {
  const int lane = threadIdx.x & 31;
  const int take = min(q.n, 32);
  q.n -= take;
  const bool have = lane < take;
  int out = 0, cv = 0, b = 0, t = 0;
  float hs = 0.0f;
  if (have) {
    out = q.out[q.n + lane];
    cv = q.cv[q.n + lane];
    b = q.bt[q.n + lane] >> 16;
    t = q.bt[q.n + lane] & 0xffff;
    hs = q.hs[q.n + lane];
  }
  __syncwarp();
  bool keep = false;
  if (have) {
    const uint16_t* w =
        a.canvas + static_cast<size_t>(b) * a.C * a.H * a.W + cv;
    bool alive = true;
    int my_nw = 0, rej = 0;
    if (kHeap2) {
      // the three features of kAhead stages loaded together (a stage's
      // offsets do not depend on the walk), then those stages in order
      const int4* s = reinterpret_cast<const int4*>(tab);
      bool more = true;
      while (more && t < a.T) {
        float v[kAhead][3];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int tu = min(t + u, a.T - 1);
          const int4 sa = s[3 * tu], sq = s[3 * tu + 1];
          v[u][0] = load(w, sa.x);
          v[u][1] = load(w, sa.z);
          v[u][2] = load(w, sq.x);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (more && t < a.T) {
            const int4 sa = s[3 * t], sq = s[3 * t + 1], sp = s[3 * t + 2];
            const float theta = __int_as_float(sq.z);
            my_nw += sq.w;
            hs = __fadd_rn(hs, leaf(sa, sq, sp, v[u][0], v[u][1], v[u][2]));
            ++t;
            if (!(hs >= theta)) {
              alive = false;
              more = false;
            } else if (theta != -INFINITY && ++rej == kRejects) {
              more = false;
            }
          }
        }
      }
    } else {
      const int2* stage = reinterpret_cast<const int2*>(tab);
      const int4* recs =
          reinterpret_cast<const int4*>(tab + 2 * ((a.T + 1) & ~1));
      while (t < a.T) {
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
    keep = alive && t < a.T;
    const int my_cnt = !keep && alive;
    if (b == wb) {
      nw += my_nw;
      cnt += my_cnt;
    } else {  // a survivor of an earlier image: rare
      if (my_nw) atomicAdd(a.n_weak + b, my_nw);
      if (my_cnt) atomicAdd(a.count + b, my_cnt);
    }
    if (!keep)
      a.out[static_cast<size_t>(b) * a.gu * a.gv + out] =
          alive ? hs : -INFINITY;
  }
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  if (keep) {
    const int at = q.n + __popc(mask & ((1u << lane) - 1u));
    q.out[at] = out;
    q.cv[at] = cv;
    q.bt[at] = b << 16 | t;
    q.hs[at] = hs;
  }
  q.n += __popc(mask);
  __syncwarp();
}

// ---- the front -----------------------------------------------------------

// The kP canvas values of one feature for this thread's origins: elements
// e .. e+kP-1 of a staged footprint (e - e % kP a multiple of kP, so the
// run lies in two aligned kP-element vectors; e % kP is the feature's and
// the same in every thread, so the word shift is warp-uniform).
template <int kN>
struct VecOf;
template <>
struct VecOf<1> {
  using T = uint32_t;
};
template <>
struct VecOf<2> {
  using T = uint2;
};
template <>
struct VecOf<4> {
  using T = uint4;
};

__device__ __forceinline__ void words(const uint32_t& v, uint32_t* w) {
  w[0] = v;
}
__device__ __forceinline__ void words(const uint2& v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
}
__device__ __forceinline__ void words(const uint4& v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

template <int N>
__device__ __forceinline__ void gather(const uint8_t* fb, int e,
                                       float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = widen(reinterpret_cast<const uint16_t*>(fb)[e]);
  } else {
    constexpr int kW = N / 2;  // words of one vector
    using V = typename VecOf<kW>::T;
    const V* at = reinterpret_cast<const V*>(fb) + e / N;
    uint32_t w[2 * kW];
    words(at[0], w);
    words(at[1], w + kW);
    const int k = (e & (N - 1)) >> 1;  // the run's first word
    uint32_t o[kW + 1];
#pragma unroll
    for (int i = 0; i <= kW; ++i) {
      uint32_t x = w[i];
#pragma unroll
      for (int kk = 1; kk < kW; ++kk)
        if (k == kk) x = w[i + kk];
      o[i] = x;
    }
    const int shift = (e & 1) * 16;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const uint32_t x = __funnelshift_r(o[i], o[i + 1], shift);
      v[2 * i] = widen(x & 0xffffu);
      v[2 * i + 1] = __uint_as_float(x & 0xffff0000u);
    }
  }
}

// The same values read from the canvas (the front in global memory):
// origins outside the grid read 0.
__device__ __forceinline__ void gather_global(
    const uint16_t* __restrict__ w, int off, int n_in, float (&v)[kP]) {
#pragma unroll
  for (int j = 0; j < kP; ++j) v[j] = j < n_in ? load(w, off + j) : 0.0f;
}

// hs[j] for a j known only at run time, without an indexed register array.
__device__ __forceinline__ float pick(const float (&hs)[kP], int j) {
  float h = hs[0];
#pragma unroll
  for (int i = 1; i < kP; ++i)
    if (j == i) h = hs[i];
  return h;
}

// kP map values at dst: as float4 (float2) vectors where `vec` (the row
// holds them all and dst lies on their size), else the first n_in alone.
template <int N>
__device__ __forceinline__ void store(float* __restrict__ dst,
                                      const float (&o)[N], bool vec,
                                      int n_in) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        reinterpret_cast<float4*>(dst)[i] =
            make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
      return;
    }
  } else if constexpr (N == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n_in) dst[j] = o[j];
}

// kStaged: the walk records in shared memory; kHeap2: their layout;
// kFront: kFrontTile, kFrontGlobal or kFrontNone.  kWarps consumer warps
// take the tiles; with kFrontTile one more warp, the producer, fills a
// ring of kBufs footprint buffers: buffer k is full when full[k]
// completes (the box copy's bytes) and free again when empty[k] does (each
// consumer warp once it has read it), so no warp waits for another's walk.
template <bool kStaged, bool kHeap2, int kFront>
__global__ void __launch_bounds__(kThreads + 32)
    cascade_fast_kernel(const __grid_constant__ CUtensorMap map,
                        const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kBuffers = kFront == kFrontTile ? kBufs : 0;
  // buffers, mbarriers (full, empty), front records, walk records, queues
  uint8_t* sBuf = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBuffers * a.fbytes);
  uint64_t* empty = full + kBufs;
  int* sFront = reinterpret_cast<int*>(full + 2 * kBufs);
  int* sTab = sFront + 12 * a.F;
  int* sQ = sTab + (kStaged ? a.table_bytes / 4 : 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {  // stage the records: 16-byte cp.async
    auto put = [&](int* dst, const int* src, int bytes) {
      for (int i = tid; i < bytes / 16; i += kThreads + 32) {
        const unsigned at = smem_at(dst + 4 * i);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
                     "l"(src + 4 * i)
                     : "memory");
      }
    };
    put(sFront, a.front, 48 * a.F);
    if (kStaged) put(sTab, a.table, a.table_bytes);
    cp_async_commit();
    cp_async_wait<0>();
  }
  if (kBuffers && tid == 0) {
    for (int k = 0; k < kBuffers; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // this block's run of tiles (images slowest): its queued survivors
  // mostly belong to the image it is in
  const int lo = static_cast<int>(static_cast<long long>(a.n_tiles) *
                                  blockIdx.x / gridDim.x);
  const int n_mine = static_cast<int>(static_cast<long long>(a.n_tiles) *
                                      (blockIdx.x + 1) / gridDim.x) - lo;
  auto tile_at = [&](int i, int& b, int& R0, int& C0) {
    const int tile = lo + i;
    b = tile / a.tiles_img;
    const int rest = tile - b * a.tiles_img, tr = rest / a.tiles_c;
    R0 = tr * kTR;
    C0 = (rest - tr * a.tiles_c) * kTC;
  };

  if (warp == kWarps) {  // the producer
    if (kBuffers) {
      for (int i = 0; i < n_mine; ++i) {
        const int k = i % kBuffers, use = i / kBuffers;
        if (use) mbar_wait(empty + k, (use - 1) & 1u);
        int b, R0, C0;
        tile_at(i, b, R0, C0);
        uint8_t* dst = sBuf + k * a.fbytes;
        if (lane == 0) {
          fence_proxy_async();
          mbar_expect_tx(full + k, 2u * a.C * a.fh * a.fw);
          tma_load_3d(dst, &map, C0, R0, b * a.C, full + k);
        }
      }
    }
    return;
  }

  const int* tab = kStaged ? sTab : a.table;
  const int4* front = reinterpret_cast<const int4*>(sFront);
  Queue q{sQ + warp * kQueue, sQ + (kWarps + warp) * kQueue,
          sQ + (2 * kWarps + warp) * kQueue,
          reinterpret_cast<float*>(sQ + (3 * kWarps + warp) * kQueue), 0};
  const int rl = tid / kRowThreads, cl = (tid - rl * kRowThreads) * kP;
  const size_t img = static_cast<size_t>(a.C) * a.H * a.W;
  const bool finish = a.F >= a.T;  // the front runs every stage
  int nw = 0, cnt = 0, wb = -1;    // this lane's sums for image wb
  auto drain = [&](bool all) {
    while (q.n >= 32 || (all && q.n > 0)) pass<kHeap2>(q, tab, a, wb, nw, cnt);
  };

  for (int i = 0; i < n_mine; ++i) {
    const int k = kBuffers ? i % kBuffers : 0;
    int b, R0, C0;
    tile_at(i, b, R0, C0);
    if (b != wb) {
      flush(nw, cnt, wb, a);
      wb = b;
    }
    const int r = R0 + rl, c = C0 + cl;
    const int n_in = r < a.gu ? max(min(a.gv - c, kP), 0) : 0;
    unsigned alive = 0;  // bit j: origin c + j valid
    if (n_in) {
      const uint8_t* vr = a.valid + static_cast<size_t>(r) * a.gv + c;
      if (kP > 1 && a.vec_valid && n_in == kP) {
        uint32_t x[2] = {0, 0};
        if constexpr (kP == 2) x[0] = *reinterpret_cast<const uint16_t*>(vr);
        if constexpr (kP == 4) x[0] = *reinterpret_cast<const uint32_t*>(vr);
        if constexpr (kP == 8) {
          const uint2 y = *reinterpret_cast<const uint2*>(vr);
          x[0] = y.x;
          x[1] = y.y;
        }
#pragma unroll
        for (int j = 0; j < kP; ++j)
          if ((x[j >> 2] >> (8 * (j & 3))) & 255u) alive |= 1u << j;
      } else {
#pragma unroll
        for (int j = 0; j < kP; ++j)
          if (j < n_in && vr[j]) alive |= 1u << j;
      }
    }

    // the mask is read above while the footprint is still on its way
    if (kBuffers) mbar_wait(full + k, (i / kBuffers) & 1u);
    float hs[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) hs[j] = 0.0f;
    if (kFront != kFrontNone) {
      const uint8_t* fb = sBuf + k * a.fbytes;
      const int tb = rl * a.fw + cl;  // element of this thread's origin
      const uint16_t* w = a.canvas + b * img + static_cast<size_t>(r) * a.W +
                          c;  // kFrontGlobal
      for (int t = 0; t < a.F && __any_sync(0xffffffffu, alive); ++t) {
        const int4 sa = front[3 * t], sq = front[3 * t + 1],
                   sp = front[3 * t + 2];
        float v0[kP], v1[kP], v2[kP];
        if (kFront == kFrontTile) {
          gather(fb, tb + sa.x, v0);
          gather(fb, tb + sa.z, v1);
          gather(fb, tb + sq.x, v2);
        } else {
          gather_global(w, sa.x, n_in, v0);
          gather_global(w, sa.z, n_in, v1);
          gather_global(w, sq.x, n_in, v2);
        }
        const float theta = __int_as_float(sq.z);
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          hs[j] = __fadd_rn(hs[j], leaf(sa, sq, sp, v0[j], v1[j], v2[j]));
          if ((alive >> j) & 1u) {
            nw += sq.w;
            if (!(hs[j] >= theta)) alive &= ~(1u << j);
          }
        }
      }
    }
    if (kBuffers) {
      __syncwarp();  // the footprint is read
      if (lane == 0) mbar_arrive(empty + k);
    }

    // the map: survivors of every stage and the dead; queued windows -inf
    // until the walk writes them
    if (n_in) {
      float o[kP];
#pragma unroll
      for (int j = 0; j < kP; ++j)
        o[j] = finish && ((alive >> j) & 1u) ? hs[j] : -INFINITY;
      if (finish) cnt += __popc(alive);
      float* dst = a.out + (static_cast<size_t>(b) * a.gu + r) * a.gv + c;
      store(dst, o, a.vec_out && n_in == kP, n_in);
    }
    __syncwarp();  // the map's placeholders before the walk's values

    // the rest of the walk: the survivors onto the queue, one origin of
    // each thread at a time, a pass whenever it holds 32
    const unsigned queued = finish ? 0u : alive;
    if (__any_sync(0xffffffffu, queued)) {
#pragma unroll 1
      for (int j = 0; j < kP; ++j) {
        const bool keep = (queued >> j) & 1u;
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          const int at = q.n + __popc(mask & ((1u << lane) - 1u));
          q.out[at] = r * a.gv + c + j;
          q.cv[at] = r * a.W + c + j;
          q.bt[at] = b << 16 | a.F;
          q.hs[at] = pick(hs, j);
        }
        q.n += __popc(mask);
        __syncwarp();
        drain(false);
      }
    }
  }
  drain(true);
  flush(nw, cnt, wb, a);
}

// ---- the host --------------------------------------------------------------

// Blocks of an instance that the card holds at once with `smem` bytes of
// dynamic shared memory: the opt-in to the device's most, once per device
// and kernel, then the occupancy, once per device, kernel and size; 0 and
// the error on failure.
std::pair<long long, int> resident(const void* kernel, int smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> optin;
  static std::map<std::tuple<int, const void*, int>, long long> fit;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = fit.find({dev, kernel, smem});
  if (it != fit.end()) return {it->second, 0};
  auto most = optin.find({dev, kernel});
  if (most == optin.end()) {
    int bytes = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return {0, static_cast<int>(e)};
    most = optin.emplace(std::make_pair(dev, kernel), bytes).first;
  }
  if (smem > most->second)
    return {0, static_cast<int>(cudaErrorInvalidValue)};
  int n = 0, sms = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads + 32,
                                                    smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return {0, static_cast<int>(e)};
  if (n < 1) return {0, static_cast<int>(cudaErrorInvalidConfiguration)};
  return {fit[{dev, kernel, smem}] = static_cast<long long>(n) * sms, 0};
}

// The tensor map of a canvas, encoded once per device, base address, shape
// and box: serving calls get their canvas from the caching allocator at
// the same address, so the host's encode leaves their path.
bool canvas_map(CUtensorMap* map, const void* canvas,
                const cuuint64_t* dims, const cuuint32_t* box) {
  using Key = std::tuple<int, const void*, cuuint64_t, cuuint64_t, cuuint64_t,
                         cuuint32_t, cuuint32_t, cuuint32_t>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const Key key{dev,     canvas, dims[0], dims[1],
                dims[2], box[0], box[1],  box[2]};
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *map = it->second;
    return true;
  }
  if (!tensor_map(map, canvas, 2, 3, dims, box)) return false;
  if (seen.size() >= 64) seen.clear();
  seen.emplace(key, *map);
  return true;
}

template <bool kStaged, bool kHeap2, int kFront>
int launch_grid(const Args& a, const CUtensorMap& map, cudaStream_t st) {
  const auto kernel = cascade_fast_kernel<kStaged, kHeap2, kFront>;
  const int buffers = kFront == kFrontTile ? kBufs * a.fbytes : 0;
  const int smem = buffers + 16 * kBufs + 48 * a.F +
                   (kStaged ? a.table_bytes : 0) + 4 * kWarps * kQueue * 4;
  const auto [slots, err] = resident(reinterpret_cast<const void*>(kernel),
                                     smem);
  if (err) return err;
  const int grid = static_cast<int>(a.n_tiles < slots ? a.n_tiles : slots);
  kernel<<<grid, kThreads + 32, smem, st>>>(map, a);
  return 0;
}

template <bool kStaged, bool kHeap2>
int launch_front(const Args& a, int front_mode, const CUtensorMap& map,
                 cudaStream_t st) {
  if (front_mode == kFrontTile)
    return launch_grid<kStaged, kHeap2, kFrontTile>(a, map, st);
  if (front_mode == kFrontGlobal)
    return launch_grid<kStaged, kHeap2, kFrontGlobal>(a, map, st);
  return launch_grid<kStaged, kHeap2, kFrontNone>(a, map, st);
}

template <bool kHeap2>
int launch_layout(const Args& a, int front_mode, const CUtensorMap& map,
                  cudaStream_t st) {
  if (a.table_bytes <= kSmemTables)
    return launch_front<true, kHeap2>(a, front_mode, map, st);
  return launch_front<false, kHeap2>(a, front_mode, map, st);
}

}  // namespace

// The tile of origins the front's records must be built for.
extern "C" void wb_cascade_fast_tile(int* rows, int* cols) {
  *rows = kTR;
  *cols = kTC;
}

// B3f: masked map, survivor count and n_weak over all T stages of a
// (batch, C, H, W) bfloat16 canvas.  sums: 2 x batch ints, the count then
// n_weak, zeroed here.  table / table_bytes / layout: the walk's records
// (canvas strides); front / F / front_mode: the front's F HEAP2 stages
// (front_mode 1: in the strides of a footprint of kTR + m - 1 rows and
// kTC + n - 1 columns rounded up to 8, the tile wb_cascade_fast_tile
// reports, staged by TMA, which needs the canvas rows and base on 16
// bytes; 2: canvas strides, read from global memory; 0: no front, F 0);
// m, n: the window.
// The arguments from C to front_mode are the same for every call at one
// canvas shape.
extern "C" int wb_cascade_fast(const void* canvas, int batch,
                               const void* valid, void* masked, void* sums,
                               int C, int H, int W, int gu, int gv, int m,
                               int n, const void* table, int table_bytes,
                               int layout, int T, int NN, const void* front,
                               int F, int front_mode, void* stream) {
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a queue entry packs image << 16 | stage
  if (batch >= (1 << 15) || T >= (1 << 16) || F < 0 || F > T ||
      (front_mode != kFrontNone) != (F > 0) || front_mode < 0 ||
      front_mode > kFrontGlobal)
    return bad;
  if (front_mode == kFrontTile &&
      (W % 8 != 0 || reinterpret_cast<uintptr_t>(canvas) % 16 != 0))
    return bad;
  if (batch <= 0) return 0;
  cudaError_t z = cudaMemsetAsync(sums, 0, sizeof(int) * 2 * batch, st);
  if (z != cudaSuccess) return static_cast<int>(z);
  if (gu <= 0 || gv <= 0) return 0;
  Args a{};
  a.canvas = static_cast<const uint16_t*>(canvas);
  a.batch = batch;
  a.C = C;
  a.H = H;
  a.W = W;
  a.valid = static_cast<const uint8_t*>(valid);
  a.gu = gu;
  a.gv = gv;
  a.table = static_cast<const int*>(table);
  a.table_bytes = table_bytes;
  a.T = T;
  a.NN = NN;
  a.front = static_cast<const int*>(front);
  a.F = F;
  a.fh = kTR + m - 1;
  a.fw = (kTC + n - 1 + 7) / 8 * 8;
  // + 16 bytes: a thread's second vector may reach past the footprint
  a.fbytes = front_mode == kFrontTile
                 ? (2 * C * a.fh * a.fw + 16 + 127) / 128 * 128
                 : 0;
  a.out = static_cast<float*>(masked);
  a.count = static_cast<int*>(sums);
  a.n_weak = a.count + batch;
  a.tiles_c = (gv + kTC - 1) / kTC;
  a.tiles_img = (gu + kTR - 1) / kTR * a.tiles_c;
  const long long n_tiles = static_cast<long long>(batch) * a.tiles_img;
  if (n_tiles >= (1ll << 31)) return bad;
  a.n_tiles = static_cast<int>(n_tiles);
  a.vec_valid = gv % kP == 0 &&
                reinterpret_cast<uintptr_t>(valid) % kP == 0;
  a.vec_out = gv % kP == 0 &&
              reinterpret_cast<uintptr_t>(masked) % (4 * kP) == 0;
  CUtensorMap map{};
  if (front_mode == kFrontTile) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(batch) * C};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(a.fw),
                               static_cast<cuuint32_t>(a.fh),
                               static_cast<cuuint32_t>(C)};
    if (a.fw > 256 || a.fh > 256 || C > 256 ||
        !canvas_map(&map, canvas, dims, box))
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int e = layout == kLayoutHeap2
                    ? launch_layout<true>(a, front_mode, map, st)
                    : launch_layout<false>(a, front_mode, map, st);
  if (e) return e;
  return static_cast<int>(cudaGetLastError());
}
