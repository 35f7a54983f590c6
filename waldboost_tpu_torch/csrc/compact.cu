// S2: the exact, order-keeping top-k of each row of a score map, in one
// cooperative launch, with nothing read back by the host.
//
//  wb_topk  per row of a (B, n) float32 map (or of hs with an alive mask:
//           hs where alive, -inf elsewhere), the first k entries of the
//           row's stable descending sort: the finite entries by score
//           descending, then flat index ascending; after them, when fewer
//           than k are finite, the non-finite entries by index.  Outputs
//           (B, k) scores and int64 indices and the (B,) count of entries
//           present (finite, or alive where a mask is given).  With the
//           box tables of a window grid (the dense extraction,
//           ops/nms.py::extract_detections) it also writes each slot's
//           validity and image-space box and each row's clamped survivor
//           count, where the slot's index becomes final: the extraction
//           is this one launch.
//
// Replaces the XLA ops jax.lax.approx_max_k(masked, cap,
// recall_target=1.0) of two-phase serving
// (waldboost_tpu/parallel/detect.py:759) and the top-k of every
// extraction (waldboost_tpu/ops/nms.py:116, :154; lax.top_k of
// detect.py:767); JAX runs them in XLA (a sort) and has no kernel here.
// On the H100 the port's full-map torch.sort took 43% of config 5's
// device time.
//
// Order as keys.  Entry j with value v maps to the 64-bit key
// hi << 32 | j, hi the order-flipped bits of v (+0 for -0, so the two
// zeros tie as in a comparison sort) for a finite v and 0xffffffff for
// any other: ascending keys are the wanted order and no two are equal.
//
// Design: blocks of 512 threads, as many as fit the card, each taking a
// contiguous run of tiles of 8192 entries (a thread 16 consecutive
// entries, by 16-byte vector loads where the rows allow), with a grid
// barrier between phases (the cooperative launch keeps every block
// resident):
//  1. count: each tile's finite and present entries, and a histogram of
//     the key's top 11 bits over the finite ones (shared-memory atomics,
//     one a bin and warp, flushed to the row's histogram in L2 when the
//     block's run moves to the next row); a tile of at most kStash
//     finite entries stashes their keys, in index order.  Then one block
//     a row resolves it: a row with at most k finite entries (the common
//     case) takes every finite entry and the first k - F others, so T =
//     0xffffffff; otherwise the boundary digit of the k-th key.
//  2. only when a row has more than k finite entries: two more digits
//     (11 and 10 bits) over the entries of the boundary prefix, each
//     resolved the same way, give T, the k-th smallest key's high word,
//     and r, how many entries with hi == T are taken (the first r by
//     index); then each tile's counts of hi < T and hi == T.  Each row's
//     tile counts become prefix sums (one block a row).
//  3. write: each tile's keys with hi < T go, in index order, to the
//     first n_lt = k - r slots (from the stash where it holds them); the
//     first r entries with hi == T go, in index order, to the last r
//     slots as they are final (equal hi, ascending index).  A tile with
//     nothing to write is skipped unread, so in the common case the map
//     is read once.
//  4. sort: one block a run of kRun keys of a row sorts it by a merge
//     sort (merge-path splits, two shared-memory buffers); a row of
//     several runs (more than kRun keys below T) then takes, after one
//     more barrier, each key's place as its place in its run plus a
//     binary search in every other run.  Scores are read back from the
//     map at the sorted indices (bitwise the input, -0 included).
// The count check of two-phase serving happens on the device: the
// caller compares the count present with its own.
//
// Box epilogue (with the tables): `emit_box` writes a final slot's valid
// = isfinite(score) and the XYXY box of its origin (idx / gv, idx % gv)
// through its level (clamped at 0): x1 = (float)(col - off_x), y1
// likewise, x2 = x1 + n, y2 = y1 + m, each times the level's inverse
// scale, every operation a float32 rounding of its own
// (ops/nms.py::origin_boxes bitwise); zeros where not valid.  The sort's
// `put` calls it as it writes a slot; the ties, final since the write
// pass, get theirs in phase 4 from the block of their row's first run
// (in the write pass's unrolled loop the call cost registers and
// spills).  The thread that resolves a row writes its count, or -1 above
// k.  No barrier is added.  The epilogue is a template argument of the
// kernel and its tables a parameter of their own: the top-k alone (the
// compaction) runs the code it ran without the epilogue.
//
// Bound on the H100: the map read once (5 bytes an entry with a mask)
// and the outputs written once.  At batch 8 and VGA size a call is a few
// microseconds of work, so the design is one launch and few barriers.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;             // entries of one tile
constexpr int kPer = kTile / kThreads;  // entries a thread a tile
constexpr int kBins = 2048;             // the 11-bit digits
constexpr int kRun = 2048;              // most keys one block sorts
constexpr int kStash = 64;              // finite keys a tile stashes
constexpr uint32_t kNonFinite = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;

// Workspace (int32): kGlobal words (barrier count, refine flag, several
// runs flag), kRowInts
// a row, three (B, kBins) histograms (all zeroed by the host's memset),
// then each row's n_tiles + 1 tile counts of hi < T and of hi == T
// (prefix sums once resolved), then (on 8 bytes) each tile's stash of
// kStash keys.
constexpr int kGlobal = 16;
constexpr int kRowInts = 16;
enum RowWord {
  kF = 0,        // finite entries
  kPresent = 1,  // entries present (finite, or alive)
  kPrefix = 2,   // the boundary digits so far
  kNeed = 3,     // keys still to take below the prefix
  kT = 4,        // the threshold's high word
  kR = 5,        // entries with hi == T taken
  kNLt = 6,      // entries with hi < T (k - r)
  kRefine = 7,   // 1 while the row needs another digit pass
  kRefined = 8   // 1 when the row had more than k finite entries
};

struct Args {
  const float* v;        // (B, n) map, or hs when alive is given
  const uint8_t* alive;  // (B, n) or null
  int batch, n, k, n_tiles;
  float* scores;         // (B, k)
  long long* index;      // (B, k); raw keys of hi < T until the sort
  int* present;          // (B,)
  int* ws;
  unsigned long long* stash;  // (B, n_tiles, kStash) in the workspace
  unsigned long long* runs;   // (B, k) sorted runs when k > kRun, else null
  int vec;                    // 1: the rows take 16-byte vector loads
};

// The box epilogue's tables and outputs: a second kernel parameter, so
// that Args, and the top-k's code without the epilogue, stay as they were
// (the fields in Args cost the kernel registers and spills).
struct Boxes {
  const long long* level_id;  // (n,) level of each origin, -1 outside
  const long long* offsets;   // (L, 2) canvas (y, x) of each level
  const float* inv_scales;    // (L,)
  const int* count;           // (B,) survivor counts
  int gv;                     // grid width: origin e is (e / gv, e % gv)
  float win_m, win_n;         // the window's height and width
  float* rects;               // (B, k, 4) XYXY
  uint8_t* valid;             // (B, k) bool
  int* count_out;             // (B,) count where <= k, else -1
};

__device__ __forceinline__ int* row_state(const Args& a, int b) {
  return a.ws + kGlobal + b * kRowInts;
}
__device__ __forceinline__ int* hist(const Args& a, int p, int b) {
  return a.ws + kGlobal + a.batch * kRowInts + (p * a.batch + b) * kBins;
}
// which 0: entries below T (finite ones after pass 0); 1: ties with T
__device__ __forceinline__ int* tile_counts(const Args& a, int which, int b) {
  return a.ws + kGlobal + a.batch * (kRowInts + 3 * kBins) +
         (which * a.batch + b) * (a.n_tiles + 1);
}

__device__ __forceinline__ int ld(const int* p) { return __ldcg(p); }

// The high word of an entry's key: finite values by score descending.
__device__ __forceinline__ uint32_t key_hi(float v, bool ok) {
  if (!ok || !isfinite(v)) return kNonFinite;
  uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending as unsigned
  return ~u;
}

// The score the outputs hold for entry e of row b: the map's value, or
// -inf where the mask is given and the entry is not alive.
__device__ __forceinline__ float score_of(const Args& a, int b, int e) {
  const size_t i = static_cast<size_t>(b) * a.n + e;
  if (a.alive && __ldg(a.alive + i) == 0) return -INFINITY;
  return __ldg(a.v + i);
}

// Slot `at` (b * k + pos), final, holds entry e of score s: its validity
// and image-space box, as the plain chain computes them.
__device__ __forceinline__ void emit_box(const Boxes& x, size_t at, int e,
                                         float s) {
  const bool ok = isfinite(s);
  float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (ok) {
    const int row = e / x.gv, col = e - row * x.gv;
    const long long lid = max(__ldg(x.level_id + e), 0LL);
    const float x1 =
        static_cast<float>(col - __ldg(x.offsets + 2 * lid + 1));
    const float y1 = static_cast<float>(row - __ldg(x.offsets + 2 * lid));
    const float inv = __ldg(x.inv_scales + lid);
    box = make_float4(__fmul_rn(x1, inv), __fmul_rn(y1, inv),
                      __fmul_rn(__fadd_rn(x1, x.win_n), inv),
                      __fmul_rn(__fadd_rn(y1, x.win_m), inv));
  }
  x.valid[at] = ok;
  reinterpret_cast<float4*>(x.rects)[at] = box;
}

// Block-wide exclusive sums of two values at once (in place), and their
// totals.  Every thread of the block calls it.
__device__ __forceinline__ void block_scan2(int& x, int& y, int* s_warp,
                                            int& tx, int& ty) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ix = x, iy = y;
  for (int off = 1; off < 32; off <<= 1) {
    const int ux = __shfl_up_sync(kFull, ix, off);
    const int uy = __shfl_up_sync(kFull, iy, off);
    if (lane >= off) {
      ix += ux;
      iy += uy;
    }
  }
  if (lane == 31) {
    s_warp[warp] = ix;
    s_warp[kWarps + warp] = iy;
  }
  __syncthreads();
  int bx = 0, by = 0;
  tx = ty = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int cx = s_warp[w], cy = s_warp[kWarps + w];
    if (w < warp) {
      bx += cx;
      by += cy;
    }
    tx += cx;
    ty += cy;
  }
  __syncthreads();
  x = bx + ix - x;
  y = by + iy - y;
}

// Every block waits here until all have arrived (the launch is
// cooperative, so all are resident); `target` counts the arrivals this
// block expects, the counter starts at 0.  The fence after the block's
// barrier publishes every thread's writes before the arrival.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned*>(count) < target)
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// A thread's kPer consecutive entries of a tile: values, how many lie
// in the row (a prefix), and a bit a present entry (the mask's, or every
// entry in the row without one).  Vector loads when the rows and
// pointers allow (a.vec: n a multiple of 16, bases on 16 bytes).
struct TileData {
  float v[kPer];
  int cnt;
  unsigned ok;
};

__device__ __forceinline__ void load_tile(const Args& a, int b, int base,
                                          int len, TileData& d) {
  const int e0 = threadIdx.x * kPer;
  const size_t at = static_cast<size_t>(b) * a.n + base + e0;
  d.cnt = max(0, min(kPer, len - e0));
  d.ok = 0;
  if (a.vec) {  // len is a multiple of kPer: a chunk is whole or empty
    if (d.cnt) {
      const float4* p = reinterpret_cast<const float4*>(a.v + at);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const float4 x = __ldg(p + q);
        d.v[4 * q] = x.x;
        d.v[4 * q + 1] = x.y;
        d.v[4 * q + 2] = x.z;
        d.v[4 * q + 3] = x.w;
      }
      if (a.alive) {
        const uint4 m = __ldg(reinterpret_cast<const uint4*>(a.alive + at));
        const unsigned w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          d.ok |= static_cast<unsigned>(((w[j >> 2] >> (8 * (j & 3))) &
                                         0xffu) != 0) << j;
      } else {
        d.ok = (1u << kPer) - 1u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) d.v[j] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool in = j < d.cnt;
      d.v[j] = in ? __ldg(a.v + at + j) : 0.0f;
      const bool ok = in && (a.alive == nullptr || __ldg(a.alive + at + j));
      d.ok |= static_cast<unsigned>(ok) << j;
    }
  }
}

__device__ __forceinline__ bool present(const TileData& d, int j) {
  return (d.ok >> j) & 1u;
}

// This block's contiguous run of the B * n_tiles tiles.
__device__ __forceinline__ void tile_run(const Args& a, long long& lo,
                                         long long& hi) {
  const long long n = static_cast<long long>(a.batch) * a.n_tiles;
  lo = n * blockIdx.x / gridDim.x;
  hi = n * (blockIdx.x + 1) / gridDim.x;
}

// The shared-memory histogram of digit pass p (nb bins) into row b's in
// L2, leaving it zero; pass 0 also adds the run's finite and present
// counts (thread 0's) to the row's.
__device__ void flush(const Args& a, int p, int b, int* s_hist, bool dirty,
                      int& acc_f, int& acc_p) {
  if (dirty) {
    int* h = hist(a, p, b);
    for (int i = threadIdx.x; i < (p == 2 ? 1024 : kBins); i += kThreads) {
      const int c = s_hist[i];
      if (c) {
        atomicAdd(h + i, c);
        s_hist[i] = 0;
      }
    }
  }
  if (threadIdx.x == 0 && p == 0) {
    if (acc_f) atomicAdd(row_state(a, b) + kF, acc_f);
    if (acc_p) atomicAdd(row_state(a, b) + kPresent, acc_p);
  }
  acc_f = acc_p = 0;
  __syncthreads();
}

// Digit pass p over this block's tiles: pass 0 counts each tile's finite
// and present entries, histograms the top digit of the finite ones and,
// in a tile of at most kStash, stashes their keys in index order for the
// write; passes 1 and 2 histogram the next digit of the entries under
// the row's prefix, in the rows still being refined.  s_hist is all zero
// on entry and on exit.
__device__ void digit_pass(const Args& a, int p, int* s_hist, int* s_warp) {
  long long lo, hi;
  tile_run(a, lo, hi);
  int cur = -1, acc_f = 0, acc_p = 0;
  bool dirty = false;
  for (long long t = lo; t < hi; ++t) {
    const int b = static_cast<int>(t / a.n_tiles);
    const int tt = static_cast<int>(t - static_cast<long long>(b) * a.n_tiles);
    const int* st = row_state(a, b);
    if (p && !ld(st + kRefine)) continue;
    if (b != cur) {
      if (cur >= 0) flush(a, p, cur, s_hist, dirty, acc_f, acc_p);
      cur = b;
      dirty = false;
    }
    const uint32_t prefix = p ? static_cast<uint32_t>(ld(st + kPrefix)) : 0u;
    const int base = tt * kTile, len = min(kTile, a.n - base);
    TileData d;
    load_tile(a, b, base, len, d);
    int fin = 0, pres = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool f = present(d, j) && isfinite(d.v[j]);
      const uint32_t key = key_hi(d.v[j], f);
      bool take;
      uint32_t bin;
      if (p == 0) {
        pres += a.alive ? present(d, j) : f;
        take = f;
        bin = key >> 21;
      } else if (p == 1) {
        take = f && (key >> 21) == prefix;
        bin = (key >> 10) & 0x7ff;
      } else {
        take = f && (key >> 10) == prefix;
        bin = key & 0x3ff;
      }
      fin += take;
      // one shared-memory atomic for each bin a warp's entries fall in
      const unsigned m = __ballot_sync(kFull, take);
      if (take) {
        const unsigned peers = __match_any_sync(m, bin);
        if ((threadIdx.x & 31) == __ffs(peers) - 1)
          atomicAdd(&s_hist[bin], __popc(peers));
      }
    }
    int at = fin, n_fin, n_pres;
    block_scan2(at, pres, s_warp, n_fin, n_pres);
    dirty = dirty || n_fin > 0;
    if (p == 0) {
      if (fin && n_fin <= kStash) {
        unsigned long long* stash =
            a.stash + (static_cast<size_t>(b) * a.n_tiles + tt) * kStash;
        const int e0 = base + threadIdx.x * kPer;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (present(d, j) && isfinite(d.v[j]))
            stash[at++] = static_cast<unsigned long long>(
                              key_hi(d.v[j], true)) << 32 |
                          static_cast<unsigned>(e0 + j);
        }
      }
      if (threadIdx.x == 0) {
        tile_counts(a, 0, b)[tt] = n_fin;
        tile_counts(a, 1, b)[tt] = len - n_fin;
        acc_f += n_fin;
        acc_p += n_pres;
      }
    }
  }
  if (cur >= 0) flush(a, p, cur, s_hist, dirty, acc_f, acc_p);
}

// Row b's tile counts into exclusive prefix sums (n_tiles + 1 each).
__device__ void scan_tiles(const Args& a, int b, int* s_warp) {
  int* lt = tile_counts(a, 0, b);
  int* eq = tile_counts(a, 1, b);
  int c_lt = 0, c_eq = 0;
  for (int base = 0; base < a.n_tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    int x = i < a.n_tiles ? ld(lt + i) : 0;
    int y = i < a.n_tiles ? ld(eq + i) : 0;
    int tx, ty;
    block_scan2(x, y, s_warp, tx, ty);
    if (i < a.n_tiles) {
      lt[i] = c_lt + x;
      eq[i] = c_eq + y;
    }
    c_lt += tx;
    c_eq += ty;
  }
  if (threadIdx.x == 0) {
    lt[a.n_tiles] = c_lt;
    eq[a.n_tiles] = c_eq;
  }
}

// Row b after digit pass p (one block): the boundary bin of the k-th
// key, then either T and r, or the prefix and the keys still needed for
// the next pass.  A row with at most k finite entries takes them all.
__device__ void resolve(const Args& a, int b, int p, int* s_warp,
                        int* s_res) {
  int* st = row_state(a, b);
  int need, prefix = 0;
  if (p == 0) {
    const int F = ld(st + kF);
    if (threadIdx.x == 0) a.present[b] = ld(st + kPresent);
    if (F <= a.k) {
      if (threadIdx.x == 0) {
        st[kT] = static_cast<int>(kNonFinite);
        st[kR] = a.k - F;
        st[kNLt] = F;
        if (F > kRun) a.ws[2] = 1;
      }
      scan_tiles(a, b, s_warp);
      return;
    }
    need = a.k;
    if (threadIdx.x == 0) {
      st[kRefined] = 1;
      a.ws[1] = 1;
    }
  } else {
    if (!ld(st + kRefine)) return;
    need = ld(st + kNeed);
    prefix = ld(st + kPrefix);
  }
  const int per = (p == 2 ? 1024 : kBins) / kThreads;  // 2 or 4
  const int* h = hist(a, p, b) + threadIdx.x * per;
  int c[4] = {0, 0, 0, 0}, sum = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per) c[i] = ld(h + i);
    sum += c[i];
  }
  int before = sum, unused = 0, total, total2;
  block_scan2(before, unused, s_warp, total, total2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per && before < need && need <= before + c[i]) {
      s_res[0] = threadIdx.x * per + i;
      s_res[1] = before;
      s_res[2] = c[i];
    }
    before += c[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bin = s_res[0];
    const int cum = s_res[1], cnt = s_res[2];
    const uint32_t pre = p == 0   ? bin
                         : p == 1 ? (static_cast<uint32_t>(prefix) << 11 | bin)
                                  : (static_cast<uint32_t>(prefix) << 10 | bin);
    const int low = p == 0 ? 21 : (p == 1 ? 10 : 0);
    const int rest = need - cum;  // keys taken inside this bin
    if (cnt == rest) {            // the whole bin: every key below its end
      st[kT] = static_cast<int>((pre + 1u) << low);
      st[kR] = 0;
      st[kNLt] = a.k;
      st[kRefine] = 0;
      if (a.k > kRun) a.ws[2] = 1;
    } else if (p == 2) {
      st[kT] = static_cast<int>(pre);
      st[kR] = rest;
      st[kNLt] = a.k - rest;
      st[kRefine] = 0;
      if (a.k - rest > kRun) a.ws[2] = 1;
    } else {
      st[kPrefix] = static_cast<int>(pre);
      st[kNeed] = rest;
      st[kRefine] = 1;
    }
  }
  __syncthreads();
}

// A refined row's tile counts of hi < T and hi == T, over this block's
// tiles.
__device__ void count_pass(const Args& a, int* s_warp) {
  long long lo, hi;
  tile_run(a, lo, hi);
  for (long long t = lo; t < hi; ++t) {
    const int b = static_cast<int>(t / a.n_tiles);
    const int tt = static_cast<int>(t - static_cast<long long>(b) * a.n_tiles);
    const int* st = row_state(a, b);
    if (!ld(st + kRefined)) continue;
    const uint32_t T = static_cast<uint32_t>(ld(st + kT));
    const int base = tt * kTile, len = min(kTile, a.n - base);
    TileData d;
    load_tile(a, b, base, len, d);
    int lt = 0, eq = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j >= d.cnt) continue;
      const uint32_t key = key_hi(d.v[j], present(d, j));
      lt += key < T;
      eq += key == T;
    }
    int n_lt, n_eq;
    block_scan2(lt, eq, s_warp, n_lt, n_eq);
    if (threadIdx.x == 0) {
      tile_counts(a, 0, b)[tt] = n_lt;
      tile_counts(a, 1, b)[tt] = n_eq;
    }
  }
}

// A tile's place in its row's output: entries below T before it and in
// it, ties before it and in it (from the prefix sums), whether the
// stash holds its keys below T and whether ties of it are wanted.
struct TilePlace {
  int run_lt, my_lt, run_eq, my_eq;
  bool stashed, ties;
};

__device__ __forceinline__ TilePlace tile_place(const Args& a, int b,
                                                int tt) {
  const int* st = row_state(a, b);
  const int* lt_p = tile_counts(a, 0, b) + tt;
  const int* eq_p = tile_counts(a, 1, b) + tt;
  TilePlace q;
  q.run_lt = ld(lt_p);
  q.my_lt = ld(lt_p + 1) - q.run_lt;
  q.run_eq = ld(eq_p);
  q.my_eq = ld(eq_p + 1) - q.run_eq;
  q.stashed = static_cast<uint32_t>(ld(st + kT)) == kNonFinite &&
              q.my_lt <= kStash;
  q.ties = q.my_eq > 0 && q.run_eq < ld(st + kR);
  return q;
}

// The map-reading part of one tile's write, thread by thread across the
// tile (entry j * kThreads + t in thread t, so neighbouring threads
// write neighbouring slots): its keys below T (unless the stash held
// them) in index order to the row's first n_lt slots, its first wanted
// ties, final, to the last r; it stops once both are placed.
__device__ void write_tile(const Args& a, int b, int tt, const TilePlace& q,
                           int* s_warp) {
  const int* st = row_state(a, b);
  const uint32_t T = static_cast<uint32_t>(ld(st + kT));
  const int r = ld(st + kR), n_lt = ld(st + kNLt);
  const int base = tt * kTile, len = min(kTile, a.n - base);
  const size_t row = static_cast<size_t>(b) * a.n + base;
  float v[kPer];
  unsigned ok = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = j * kThreads + threadIdx.x;
    v[j] = e < len ? __ldg(a.v + row + e) : 0.0f;
    ok |= static_cast<unsigned>(
              e < len && (a.alive == nullptr || __ldg(a.alive + row + e)))
          << j;
  }
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(a.index) +
      static_cast<size_t>(b) * a.k;
  long long* out_i = a.index + static_cast<size_t>(b) * a.k;
  float* out_s = a.scores + static_cast<size_t>(b) * a.k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int run_lt = q.run_lt, run_eq = q.run_eq;
  const int end_lt = q.run_lt + q.my_lt;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (run_lt == end_lt && run_eq >= r) break;  // the same in every thread
    const int e = j * kThreads + threadIdx.x;
    const bool okj = (ok >> j) & 1u;
    const uint32_t key = key_hi(v[j], okj);
    const bool is_lt = e < len && key < T, is_eq = e < len && key == T;
    const unsigned m_lt = __ballot_sync(kFull, is_lt);
    const unsigned m_eq = __ballot_sync(kFull, is_eq);
    if (lane == 0) {
      s_warp[warp] = __popc(m_lt);
      s_warp[kWarps + warp] = __popc(m_eq);
    }
    __syncthreads();
    int b_lt = 0, b_eq = 0, t_lt = 0, t_eq = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int cl = s_warp[w], ce = s_warp[kWarps + w];
      if (w < warp) {
        b_lt += cl;
        b_eq += ce;
      }
      t_lt += cl;
      t_eq += ce;
    }
    __syncthreads();
    if (is_lt && !q.stashed)
      keys[run_lt + b_lt + __popc(m_lt & below)] =
          static_cast<unsigned long long>(key) << 32 |
          static_cast<unsigned>(base + e);
    if (is_eq) {
      const int rank = run_eq + b_eq + __popc(m_eq & below);
      if (rank < r) {
        out_i[n_lt + rank] = base + e;
        out_s[n_lt + rank] = a.alive && !okj ? -INFINITY : v[j];
      }
    }
    run_lt += t_lt;
    run_eq += t_eq;
  }
}

// The ordered write (phase 3) over this block's tiles, kThreads tiles at
// a time: a thread reads a tile's place, a warp copies each stashed
// tile's keys, and the block reads the map for the few tiles that need
// it (wanted ties, or more entries below T than the stash holds), so no
// tile costs a serial round trip.  s_tab: 3 * kThreads ints.
__device__ void write_pass(const Args& a, int* s_tab, int* s_warp) {
  long long lo, hi;
  tile_run(a, lo, hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long c = lo; c < hi; c += kThreads) {
    const int n = static_cast<int>(min(static_cast<long long>(kThreads),
                                       hi - c));
    if (static_cast<int>(threadIdx.x) < n) {
      const long long t = c + threadIdx.x;
      const int b = static_cast<int>(t / a.n_tiles);
      const TilePlace q = tile_place(
          a, b, static_cast<int>(t - static_cast<long long>(b) * a.n_tiles));
      s_tab[3 * threadIdx.x] = q.run_lt;
      s_tab[3 * threadIdx.x + 1] = q.my_lt;
      s_tab[3 * threadIdx.x + 2] =
          (q.my_lt > 0 && q.stashed) | (q.ties || (q.my_lt > 0 &&
                                                  !q.stashed)) << 1;
    }
    __syncthreads();
    for (int i = warp; i < n; i += kWarps) {
      if (!(s_tab[3 * i + 2] & 1)) continue;
      const long long t = c + i;
      const int b = static_cast<int>(t / a.n_tiles);
      const int tt = static_cast<int>(t - static_cast<long long>(b) *
                                              a.n_tiles);
      const unsigned long long* stash =
          a.stash + (static_cast<size_t>(b) * a.n_tiles + tt) * kStash;
      unsigned long long* keys =
          reinterpret_cast<unsigned long long*>(a.index) +
          static_cast<size_t>(b) * a.k + s_tab[3 * i];
      for (int j = lane; j < s_tab[3 * i + 1]; j += 32)
        keys[j] = __ldcg(stash + j);
    }
    for (int i = 0; i < n; ++i) {
      if (!(s_tab[3 * i + 2] & 2)) continue;
      const long long t = c + i;
      const int b = static_cast<int>(t / a.n_tiles);
      const int tt = static_cast<int>(t - static_cast<long long>(b) *
                                              a.n_tiles);
      write_tile(a, b, tt, tile_place(a, b, tt), s_warp);
    }
    __syncthreads();
  }
}

template <bool kBoxes>
__device__ __forceinline__ void put(const Args& a, const Boxes& x, int b,
                                    int pos, unsigned long long key) {
  const int e = static_cast<int>(key & 0xffffffffu);
  const size_t at = static_cast<size_t>(b) * a.k + pos;
  a.index[at] = e;
  const float s = score_of(a, b, e);
  a.scores[at] = s;
  if (kBoxes) emit_box(x, at, e, s);
}

// Sort n <= kRun keys at src ascending: a merge sort in shared memory
// between two buffers of m = pow2(n) keys at s, returning the one that
// holds the result.  Each thread sorts its `it` consecutive keys (at
// most 4) in registers, then log2(m / it) rounds merge pairs of sorted
// runs, each thread producing its `it` outputs from a merge-path split
// (a binary search for how many come from the first run).  The keys are
// distinct; the padding, all the largest key, merges first-run first.
__device__ const unsigned long long* merge_sort(const unsigned long long* src,
                                                int n, unsigned long long* s) {
  int m = 1;
  while (m < n) m <<= 1;
  const int it = m > kThreads ? m / kThreads : 1;
  const int t = threadIdx.x;
  const bool active = t < m / it;
  unsigned long long* in = s;
  unsigned long long* out = s + m;
  if (active) {
    unsigned long long x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t * it + j;
      x[j] = j < it && i < n ? __ldcg(src + i) : ~0ull;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j + 1 < it && x[j] > x[j + 1]) {
          const unsigned long long y = x[j];
          x[j] = x[j + 1];
          x[j + 1] = y;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < it) in[t * it + j] = x[j];
  }
  __syncthreads();
  for (int w = it; w < m; w <<= 1) {
    if (active) {
      const int d0 = t * it, p = d0 / (2 * w) * (2 * w), d = d0 - p;
      const unsigned long long* A = in + p;
      const unsigned long long* B = A + w;
      int lo = max(0, d - w), hi = min(d, w);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (A[mid] <= B[d - mid - 1])
          lo = mid + 1;
        else
          hi = mid;
      }
      int ia = lo, ib = d - lo;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < it) {
          const bool take_a = ib >= w || (ia < w && A[ia] <= B[ib]);
          out[d0 + j] = take_a ? A[ia++] : B[ib++];
        }
      }
    }
    __syncthreads();
    unsigned long long* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// kBoxes: with the box epilogue (x set).  Without it the kernel is the
// top-k alone, its code untouched by the epilogue's.
template <bool kBoxes>
__global__ void __launch_bounds__(kThreads, 2) topk_kernel(Args a,
                                                             Boxes x) {
  extern __shared__ unsigned long long s_dyn[];  // sort keys or histogram
  __shared__ int s_warp[2 * kWarps], s_res[4];
  int* s_hist = reinterpret_cast<int*>(s_dyn);
  unsigned* count = reinterpret_cast<unsigned*>(a.ws);
  unsigned target = 0;
  for (int i = threadIdx.x; i < kBins; i += kThreads) s_hist[i] = 0;
  __syncthreads();

  // 1. counts and the top digit, then each row's resolution
  digit_pass(a, 0, s_hist, s_warp);
  grid_barrier(count, target);
  for (int b = blockIdx.x; b < a.batch; b += gridDim.x) {
    resolve(a, b, 0, s_warp, s_res);
    if (kBoxes && threadIdx.x == 0) {
      const int c = __ldg(x.count + b);
      x.count_out[b] = c <= a.k ? c : -1;
    }
  }
  grid_barrier(count, target);

  // 2. rows with more than k finite entries: two more digits, then the
  // tiles' counts against T and their prefix sums (every block reads the
  // same flag)
  if (ld(a.ws + 1)) {
    for (int p = 1; p <= 2; ++p) {
      digit_pass(a, p, s_hist, s_warp);
      grid_barrier(count, target);
      for (int b = blockIdx.x; b < a.batch; b += gridDim.x)
        resolve(a, b, p, s_warp, s_res);
      grid_barrier(count, target);
    }
    count_pass(a, s_warp);
    grid_barrier(count, target);
    for (int b = blockIdx.x; b < a.batch; b += gridDim.x)
      if (ld(row_state(a, b) + kRefined)) scan_tiles(a, b, s_warp);
    grid_barrier(count, target);
  }

  // 3. the ordered write
  write_pass(a, s_hist, s_warp);
  grid_barrier(count, target);

  // 4. the sort of each row's n_lt keys: one block a run of kRun; with
  // the box tables, the block of a row's first run also writes the boxes
  // of its ties, final since the write
  const int runs = a.runs ? (a.k + kRun - 1) / kRun : 1;
  for (int item = blockIdx.x; item < a.batch * runs; item += gridDim.x) {
    const int b = item / runs, run = item % runs;
    const int n = ld(row_state(a, b) + kNLt), lo = run * kRun;
    if (kBoxes && run == 0) {
      for (int i = n + threadIdx.x; i < a.k; i += kThreads) {
        const size_t at = static_cast<size_t>(b) * a.k + i;
        emit_box(x, at, static_cast<int>(__ldcg(a.index + at)),
                 __ldcg(a.scores + at));
      }
    }
    if (lo >= n) continue;
    const int len = min(kRun, n - lo);
    const unsigned long long* sorted = merge_sort(
        reinterpret_cast<const unsigned long long*>(a.index) +
            static_cast<size_t>(b) * a.k + lo,
        len, s_dyn);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      if (n <= kRun)
        put<kBoxes>(a, x, b, i, sorted[i]);
      else
        a.runs[static_cast<size_t>(b) * a.k + lo + i] = sorted[i];
    }
    __syncthreads();
  }
  // rows of several runs (flagged where their n_lt was set)
  if (!ld(a.ws + 2)) return;
  grid_barrier(count, target);
  // each key of a row of several runs: its place in its run plus the
  // keys below it in every other run
  const long long total = static_cast<long long>(a.batch) * a.k;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < total; g += static_cast<long long>(gridDim.x) * kThreads) {
    const int b = static_cast<int>(g / a.k), i = static_cast<int>(g % a.k);
    const int n = ld(row_state(a, b) + kNLt);
    if (n <= kRun || i >= n) continue;
    const unsigned long long* rb = a.runs + static_cast<size_t>(b) * a.k;
    const unsigned long long key = __ldcg(rb + i);
    const int run = i / kRun;
    int pos = i - run * kRun;
    for (int lo = 0; lo < n; lo += kRun) {
      if (lo == run * kRun) continue;
      int l = 0, h = min(kRun, n - lo);  // lower bound of key in the run
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (__ldcg(rb + lo + mid) < key)
          l = mid + 1;
        else
          h = mid;
      }
      pos += l;
    }
    put<kBoxes>(a, x, b, pos, key);
  }
}

// Blocks of a topk_kernel instantiation that fit the card at once for a
// dynamic shared-memory size: queried once per device, kernel and size.
int resident(const void* kernel, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> fit;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, kernel, smem);
  const auto it = fit.find(key);
  if (it != fit.end()) return it->second;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  return fit[key] = sms * per_sm;
}

// Workspace words before the stash (an even count: the stash is on 8
// bytes).
long long stash_at(int batch, long long n) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long w = kGlobal +
                      static_cast<long long>(batch) * (kRowInts + 3 * kBins) +
                      2LL * batch * (n_tiles + 1);
  return w + (w & 1);
}

}  // namespace

// Workspace int32 words wb_topk needs for `batch` rows of n entries.
extern "C" long long wb_topk_workspace(int batch, long long n) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  return stash_at(batch, n) + 2LL * batch * n_tiles * kStash;
}

// S2: per row of the (B, n) float32 map v (hs when alive, a (B, n) uint8
// mask, is given) the first k entries of its stable descending sort:
// scores (B, k) float32, index (B, k) int64, present (B,) int32.  ws:
// wb_topk_workspace words; runs: (B, k) uint64 scratch when k > 2048,
// else null.  1 <= k <= n < 2^31.  The box epilogue, with level_id not
// null: level_id (n,) int64 over a grid of width gv, offsets (L, 2)
// int64, inv_scales (L,) float32, count (B,) int32 and the window (m, n)
// in; rects (B, k, 4) float32, valid (B, k) bool, count_out (B,) int32
// out.  With level_id null the other eight are not read.
extern "C" int wb_topk(const void* v, const void* alive, int batch,
                       long long n, int k, void* scores, void* index,
                       void* present, void* ws, long long ws_words,
                       void* runs, const void* level_id, const void* offsets,
                       const void* inv_scales, const void* count, int gv,
                       float win_m, float win_n, void* rects, void* valid,
                       void* count_out, void* stream) {
  if (batch < 1 || k < 1 || k > n || n >= (1LL << 31) ||
      ws_words < wb_topk_workspace(batch, n) ||
      (k > kRun) != (runs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (level_id && (!offsets || !inv_scales || !count || !rects || !valid ||
                   !count_out || gv < 1 || n % gv != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Args a{static_cast<const float*>(v), static_cast<const uint8_t*>(alive),
         batch, static_cast<int>(n), k,
         static_cast<int>((n + kTile - 1) / kTile),
         static_cast<float*>(scores), static_cast<long long*>(index),
         static_cast<int*>(present), static_cast<int*>(ws),
         reinterpret_cast<unsigned long long*>(static_cast<int*>(ws) +
                                               stash_at(batch, n)),
         static_cast<unsigned long long*>(runs),
         n % 16 == 0 && on16(v) && (alive == nullptr || on16(alive))};
  Boxes x{static_cast<const long long*>(level_id),
          static_cast<const long long*>(offsets),
          static_cast<const float*>(inv_scales),
          static_cast<const int*>(count), gv, win_m, win_n,
          static_cast<float*>(rects), static_cast<uint8_t*>(valid),
          static_cast<int*>(count_out)};
  const size_t zero = (kGlobal + static_cast<size_t>(batch) *
                                     (kRowInts + 3 * kBins)) * sizeof(int);
  cudaError_t err = cudaMemsetAsync(ws, 0, zero, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int m = 1;
  while (m < k && m < kRun) m <<= 1;
  // the histogram, or the merge sort's two buffers
  const int smem = static_cast<int>(std::max<size_t>(
      kBins * sizeof(int), 2 * m * sizeof(unsigned long long)));
  const long long items =
      std::max<long long>(static_cast<long long>(batch) * a.n_tiles,
                          static_cast<long long>(batch) *
                              ((k + kRun - 1) / kRun));
  const void* kernel = level_id
                           ? reinterpret_cast<const void*>(topk_kernel<true>)
                           : reinterpret_cast<const void*>(topk_kernel<false>);
  const int fit = resident(kernel, smem);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(std::min<long long>(fit, items));
  void* params[] = {&a, &x};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                    params, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
