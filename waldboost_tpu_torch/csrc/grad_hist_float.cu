// grad_hist channel canvas from float or fast-mode polyphase planes:
// gradients, oriented projections, 2x2 average pool, 3x3/16 smooth,
// interior mask.  Two chains share one kernel template (the exact uint8
// chain B2 is csrc/grad_hist.cu):
//
//  wb_grad_hist_float (B2d) exact float frames: float32 planes, f32
//    canvas.  Each [1,2,1] prefilter (a + 2b) + c is summed in f64 and
//    rounded to f32 once (scipy's f64 accumulator), the gradient
//    differences are f32, each bin f32(f64(gx)*cos - f64(gy)*sin).
//    Replaces: waldboost_tpu/ops/channels_pallas.py::grad_hist_poly_pallas,
//    its float_dd variant (:373, prefilter :189-194, projection :234-238),
//    which emulates f64 in double-float pairs (ops/dd.py); the H100 has
//    native f64.
//  wb_grad_hist_fast  (B2f) fast serving mode: uint8, bfloat16 or float32
//    planes, every operation in f32 with the plain projection
//    gx*f32(cos) - gy*f32(sin), one round to bfloat16 at the store.
//    Replaces: the same pallas_call with fast=True (_make_kernel(...,
//    fast=True), odt bfloat16).
//
// Bound on the H100: bytes.  Per pooled pixel the planes are read once
// (4 elements per image: 4, 8 or 16 bytes), the interior mask once (smooth
// only) and 4 channels written (B2f: 8 bytes of bfloat16, B2d: 16 of
// float32).  B2d's f64 work comes next: per pooled pixel 13 prefilters (3
// f64 operations and a rounding to f32 each), 12 projections (3 f64
// operations and a rounding each: bin 0, cos 1 and sin 0, is |gx|), the
// 10 plane elements widened (an f64 multiply each), 85 f64 operations and
// 25 conversions.  Measured (scripts/sweep_torch_kernels.py), neither
// pipe limits these kernels: the instruction rate does, so the design cuts
// instructions.
//
// Design.  A block owns a 128 x 16 tile of channel pixels (14 with the
// smooth) of one image at a time: the grid is one wave of blocks (as many
// as the card holds), each taking a contiguous run of (tile, image) items,
// images fastest, so no SM idles while another finishes a second wave.
// An item's 4 planes (18 rows x 128 + 2 * kPad columns, elements off the
// canvas 0: the zero fill of the JAX chain's _shift) and its interior
// mask come into shared memory as one TMA tile load each, zero-filled off
// the tensor, where the plane rows and the base lie on 16 bytes (else
// words: cp.async, or one or two aligned loads and a funnel shift, so any
// plane width and base address work).  Without the smooth
// the next item's copy runs under this item's work (two buffers); with it,
// under the smooth (one buffer, so more blocks fit beside the pooled
// tile).  Each thread computes 4 adjacent pooled pixels of two rows, one
// pass a row: a pass reads each of its 4 image rows as one 16- or 8-byte
// shared load per float plane (lanes on consecutive addresses: no bank
// conflict; uint8 rows by bytes, conflict-free already) and takes the
// row's two outer elements from the neighbouring lanes by shuffle; then it
// walks the 10 image columns left to right, each element widened once
// (B2d: to f64 from its bits), computing the prefilters, the gradients,
// the four bins (B2f's bins 1 and 3 from two shared products) and the pool
// as soon as their columns are in.  With the smooth, the pooled rows above
// and below the tile are two more rows of the passes (16 rows for 14), the
// pooled ring-column cells of a warp's two rows 4 lanes of that warp, both
// 0 off the canvas, so the result holds for any mask; the smooth takes two
// adjacent rows a warp and reads its column neighbours through shuffles.
//
// Exactness.  Every float and double operation is an explicitly rounded
// intrinsic (and the library is built with -fmad=false), in the reference's
// association: prefilters (a + 2b) + c (B2d: in f64, one f32 rounding),
// each bin f32(f64(gx*cos - gy*sin)) in native f64 (B2d) or
// fl(fl(gx*c32) - fl(gy*s32)) (fast), pool = (((TL + BL) + TR) + BR) *
// 0.25, smooth = 9 terms left to right, times 1/16, then mask ? v : 0 (a
// term 2p or 4p is exact, so it is fused into its add).  B2d widens a
// finite float exactly from its bits: the double with the float's sign,
// exponent field and mantissa is v * 2^-896 (denormals too), so elements
// are multiplied by 2^896 and the projections' gradients meet constants
// carrying 2^896 (the same real products, so the same roundings).  A pass
// whose elements or gradients are not all finite is recomputed with the
// reference's conversions.

#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kTW = 128;               // output tile width (channel px)
constexpr int kBX = 32, kBY = 8;       // threads: 4 columns x 2 rows each
constexpr int kThreads = kBX * kBY;
constexpr int kBins = 4;

// The chains: B2d (f32 planes, f64 prefilters, f64 projection, f32
// canvas), B2f (f32 arithmetic, bfloat16 canvas).
constexpr int kFloat = 1, kFast = 2;

// Choices measured by scripts/sweep_torch_kernels.py: buffers of staged
// planes (2: the next item is copied during this one's passes; with the
// smooth one, so that more blocks fit beside the pooled tile) and the
// blocks an SM must hold with the smooth (the launch bound: registers),
// one fewer without it (more registers; no smooth to overlap).
constexpr int kBufsSmooth0 = 2, kBufsSmooth1 = 1;
constexpr int kBlocksB2d = 2, kBlocksF32 = 3, kBlocksBf16 = 3, kBlocksU8 = 4;
constexpr int kFewerBlocksSmooth0 = 1;

template <bool kSmooth>
constexpr int kBufsOf = kSmooth ? kBufsSmooth1 : kBufsSmooth0;
// Float rows are read as one 16- or 8-byte load per plane (lanes on
// consecutive words: no bank conflict); uint8 rows byte by byte, where
// lane tx's bytes lie in word tx + 4 (no conflict either; measured
// faster than one word and shuffles).
template <int kIn>
constexpr bool kVectorOf = kIn != 1;
template <bool kSmooth, int kChain, int kIn>
constexpr int kBlocksOf = (kChain == kFloat ? kBlocksB2d
                           : kIn == 4       ? kBlocksF32
                           : kIn == 2       ? kBlocksBf16
                                            : kBlocksU8) -
                          (kSmooth ? 0 : kFewerBlocksSmooth0);

// Staged columns left and right of the tile: 16 bytes, so every staged
// row starts on 16 bytes of the plane row (J0 is a multiple of 128).
template <int kIn>
constexpr int kPad = 16 / kIn;
template <int kIn>
constexpr int kRowBytes = (kTW + 2 * kPad<kIn>)*kIn;  // 544, 288, 160

// A plane element in registers: int (uint8 planes) or float.
template <int kIn>
using Elem = std::conditional_t<kIn == 1, int, float>;

// The tile of one item and its dynamic shared memory (bytes): the pooled
// tile and its ring columns (smooth only), two staged interior masks
// (smooth only), kBufs buffers of staged planes.
template <bool kSmooth, int kIn, int kBufs>
struct Tile {
  static constexpr int kTH = kSmooth ? 14 : 16;   // output rows
  static constexpr int kRow0 = kSmooth ? 2 : 1;   // staged rows from I0-kRow0
  static constexpr int kPlaneRows = 18;           // image rows 2I0-3 .. / -1 ..
  static constexpr int kPoolRows = kTH + 2;       // pooled I0-1 .. I0+kTH
  static constexpr int kPooled = kSmooth ? 4 * kBins * kPoolRows * kTW : 0;
  static constexpr int kRing = kSmooth ? 4 * kBins * kPoolRows * 2 : 0;
  static constexpr int kMask = kSmooth ? kTH * kTW : 0;
  static constexpr int kPlanes = 4 * kPlaneRows * kRowBytes<kIn>;
  static constexpr size_t kBytes =
      static_cast<size_t>(kPooled + kRing + 2 * kMask + kBufs * kPlanes);
};

// Projection constants of the four bins: f64, f64 times 2^896 (B2d's
// gradients from their bits carry 2^-896) and the f32 roundings (B2f).
struct Proj {
  double c[kBins];
  double s[kBins];
  double cu[kBins];
  double su[kBins];
  float cf[kBins];
  float sf[kBins];
};

// A finite float as double times 2^-896, exactly, from its bits (no
// conversion): sign, exponent field and mantissa moved into place.
__device__ __forceinline__ double scaled_f64(float v) {
  const uint32_t u = __float_as_uint(v);
  return __hiloint2double(
      static_cast<int>((u & 0x80000000u) | ((u >> 3) & 0x0fffffffu)),
      static_cast<int>(u << 29));
}

// ---- the chains: widen an element, prefilter, difference, bins --------

// B2d.  kBits: elements and gradients from their bits (finite values);
// otherwise the reference's conversions (any values).
template <bool kBits>
struct FloatChain {
  using W = double;
  static constexpr bool kCheck = kBits;  // gradients must be finite
  static __device__ __forceinline__ W widen(float v) {
    if constexpr (kBits)
      return __dmul_rn(scaled_f64(v), 0x1p896);
    else
      return static_cast<double>(v);
  }
  static __device__ __forceinline__ float tap(W a, W b, W c) {
    return __double2float_rn(__dadd_rn(__dadd_rn(a, __dmul_rn(2.0, b)), c));
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ void bins(float gx, float gy,
                                              const Proj& pj, bool first,
                                              float (&acc)[kBins]) {
    float b[kBins];
    if constexpr (kBits) {
      // bin 0: f32(f64(gx) * 1 - f64(gy) * 0) is gx for finite gy
      b[0] = fabsf(gx);
      // the gradients times 2^-896 from their bits, the constants times
      // 2^896
      const double dx = scaled_f64(gx), dy = scaled_f64(gy);
      const double* c = pj.cu;
      const double* s = pj.su;
#pragma unroll
      for (int k = 1; k < kBins; ++k)
        b[k] = fabsf(__double2float_rn(
            __dsub_rn(__dmul_rn(dx, c[k]), __dmul_rn(dy, s[k]))));
    } else {
      const double dx = gx, dy = gy;
#pragma unroll
      for (int k = 0; k < kBins; ++k)
        b[k] = fabsf(__double2float_rn(
            __dsub_rn(__dmul_rn(dx, pj.c[k]), __dmul_rn(dy, pj.s[k]))));
    }
#pragma unroll
    for (int k = 0; k < kBins; ++k)
      acc[k] = first ? b[k] : __fadd_rn(acc[k], b[k]);
  }
};

// B2f on float planes (f32) or uint8 planes (integer prefilters and
// gradients: exact in f32 too).  Bins in the reference's f32 chain
// fl(fl(fx*c) - fl(fy*s)), taken through the f32 constants'
// identities (c1 = s1 = s3 = -c3, s2 = 1; checked by projections()): bin 1
// fl(p - q) and bin 3 -fl(p + q) of p = fl(fx*c1), q = fl(fy*c1), bin 2
// fl(fl(fx*c2) - fy).
template <class G>
struct FastChain {
  using W = G;
  static constexpr bool kCheck = false;
  static __device__ __forceinline__ W widen(G v) { return v; }
  static __device__ __forceinline__ G tap(G a, G b, G c) {
    if constexpr (std::is_same<G, int>::value)
      return a + 2 * b + c;
    else
      return __fadd_rn(__fmaf_rn(2.0f, b, a), c);
  }
  static __device__ __forceinline__ G sub(G a, G b) {
    if constexpr (std::is_same<G, int>::value)
      return a - b;
    else
      return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ void bins(G gx, G gy, const Proj& pj,
                                              bool first,
                                              float (&acc)[kBins]) {
    float fx, fy;
    if constexpr (std::is_same<G, int>::value) {
      fx = __int2float_rn(gx);
      fy = __int2float_rn(gy);
    } else {
      fx = gx;
      fy = gy;
    }
    float b[kBins];
    b[0] = fabsf(fx);  // fx * 1 - fy * 0
    const float p = __fmul_rn(fx, pj.cf[1]), q = __fmul_rn(fy, pj.cf[1]);
    b[1] = fabsf(__fsub_rn(p, q));
    b[2] = fabsf(__fsub_rn(__fmul_rn(fx, pj.cf[2]), fy));
    b[3] = fabsf(__fadd_rn(p, q));
#pragma unroll
    for (int k = 0; k < kBins; ++k)
      acc[k] = first ? b[k] : __fadd_rn(acc[k], b[k]);
  }
};

// ---- reading the staged planes ----------------------------------------

// The raw bits of staged element idx of a row.
template <int kIn>
__device__ __forceinline__ uint32_t raw_at(const uint8_t* row, int idx) {
  if constexpr (kIn == 1)
    return row[idx];
  else if constexpr (kIn == 2)
    return reinterpret_cast<const uint16_t*>(row)[idx];
  else
    return reinterpret_cast<const uint32_t*>(row)[idx];
}

// A plane element from its raw bits: uint8 as int, bfloat16 and float32
// as float.
template <int kIn>
__device__ __forceinline__ Elem<kIn> elem_of(uint32_t raw) {
  if constexpr (kIn == 1)
    return static_cast<int>(raw);
  else if constexpr (kIn == 2)
    return __uint_as_float(raw << 16);
  else
    return __uint_as_float(raw);
}

// One image row of a pass (columns 8tx-1 .. 8tx+8) as loaded: each plane's
// 4 elements packed as in shared memory (q0: phase-0 columns 4tx .. 4tx+3,
// the image columns at odd c; q1: phase-1 columns 4tx .. 4tx+3, even c >=
// 2) and the outer elements l (c = 0) and r (c = 9); an element is
// unpacked when the pass reaches its column.
template <int kIn>
struct Row {
  using G = Elem<kIn>;
  using V = std::conditional_t<
      kIn == 4, float4, std::conditional_t<kIn == 2, uint2, uint32_t>>;
  V q0, q1;
  G l, r;

  static __device__ __forceinline__ G at(const V& q, int k) {
    if constexpr (kIn == 4)
      return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
    else if constexpr (kIn == 2)
      return __uint_as_float(k & 1 ? (k < 2 ? q.x : q.y) & 0xffff0000u
                                   : (k < 2 ? q.x : q.y) << 16);
    else
      return static_cast<int>((q >> (8 * k)) & 255u);
  }
  __device__ __forceinline__ G get(int c) const {
    return c == 0 ? l : c == 9 ? r : c & 1 ? at(q0, (c - 1) >> 1)
                                           : at(q1, (c >> 1) - 1);
  }
};

// Four staged elements idx .. idx+3 (idx a multiple of 4): one 16-, 8- or
// 4-byte shared load, or four scalar loads packed (uint8: lane tx reads
// word tx + 4, so bytes need no wider load).
template <int kIn>
__device__ __forceinline__ typename Row<kIn>::V load4(const uint8_t* row,
                                                     int idx) {
  using V = typename Row<kIn>::V;
  if constexpr (kVectorOf<kIn>) {
    return *reinterpret_cast<const V*>(row + kIn * idx);
  } else {
    uint32_t e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = raw_at<kIn>(row, idx + k);
    if constexpr (kIn == 4)
      return make_float4(__uint_as_float(e[0]), __uint_as_float(e[1]),
                         __uint_as_float(e[2]), __uint_as_float(e[3]));
    else if constexpr (kIn == 2)
      return make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16);
    else
      return e[0] | e[1] << 8 | e[2] << 16 | e[3] << 24;
  }
}

// Staged row of plane (a, q) for local image row Y of the tile.
template <class T, int kIn>
__device__ __forceinline__ const uint8_t* staged_row(const uint8_t* sP, int Y,
                                                     int q) {
  const int pl = (Y & 1) * 2 + q;
  return sP + (pl * T::kPlaneRows + (Y >> 1) + T::kRow0) * kRowBytes<kIn>;
}

// Local image row Y of thread tx: each plane's 4 elements in one load, the
// outer elements from the neighbouring lanes by shuffle (lanes 0 and 31
// read theirs: every lane loads the same address, a broadcast).
template <class T, int kIn>
__device__ __forceinline__ Row<kIn> image_row(const uint8_t* sP, int Y,
                                              int tx) {
  const uint8_t* r0 = staged_row<T, kIn>(sP, Y, 0);
  const uint8_t* r1 = staged_row<T, kIn>(sP, Y, 1);
  const int at = 4 * tx + kPad<kIn>;
  Row<kIn> row;
  row.q0 = load4<kIn>(r0, at);
  row.q1 = load4<kIn>(r1, at);
  const Elem<kIn> right =
      __shfl_down_sync(0xffffffffu, Row<kIn>::at(row.q0, 0), 1);
  const Elem<kIn> left =
      __shfl_up_sync(0xffffffffu, Row<kIn>::at(row.q1, 3), 1);
  const Elem<kIn> edge_r = elem_of<kIn>(raw_at<kIn>(r0, kTW + kPad<kIn>));
  const Elem<kIn> edge_l = elem_of<kIn>(raw_at<kIn>(r1, kPad<kIn> - 1));
  row.l = tx == 0 ? edge_l : left;
  row.r = tx == kBX - 1 ? edge_r : right;
  return row;
}

// One pass: the pooled bins v[k][g] of 4 pooled pixels from the 4 x 10
// image pixels of rows p (rows 2i-1 .. 2i+2, columns 2j0-1 .. 2j0+8),
// walking the columns left to right: column c's elements are widened
// once, its two vertical prefilters taken, and once c >= 2 the four
// horizontal prefilters of column c-1, the gradients of image column x =
// c-1 in both rows and their bins (x odd: TL and BL; x even: TR and BR,
// then the pool).
// In the reference's signs: gx = left minus right of the vertical [1,2,1],
// gy = above minus below of the horizontal one.  Returns the gradients'
// sum of g * 0 (0 while all are finite).
template <class C, int kIn>
__device__ __forceinline__ float pass(const Row<kIn> (&p)[4], const Proj& pj,
                                      float (&v)[kBins][4]) {
  using W = typename C::W;
  using R = decltype(C::sub(C::tap(W(), W(), W()), C::tap(W(), W(), W())));
  W w[3][4];   // widened columns c-2 .. c (index c % 3)
  R sv[3][2];  // vertical prefilters of rows 1, 2 at columns c-2 .. c
  float acc[kBins];
  float fin = 0.0f;
#pragma unroll
  for (int c = 0; c < 10; ++c) {
    const int i = c % 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) w[i][r] = C::widen(p[r].get(c));
    sv[i][0] = C::tap(w[i][0], w[i][1], w[i][2]);
    sv[i][1] = C::tap(w[i][1], w[i][2], w[i][3]);
    if (c < 2) continue;
    const int l = (c + 1) % 3, m = (c + 2) % 3;  // columns c-2, c-1
    R h[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) h[r] = C::tap(w[l][r], w[m][r], w[i][r]);
    const R gx1 = C::sub(sv[l][0], sv[i][0]), gx2 = C::sub(sv[l][1], sv[i][1]);
    const R gy1 = C::sub(h[0], h[2]), gy2 = C::sub(h[1], h[3]);
    if constexpr (C::kCheck) {
      fin = __fmaf_rn(gx1, 0.0f, fin);
      fin = __fmaf_rn(gy1, 0.0f, fin);
      fin = __fmaf_rn(gx2, 0.0f, fin);
      fin = __fmaf_rn(gy2, 0.0f, fin);
    }
    const int x = c - 1;  // image column 1 .. 8 of p
    C::bins(gx1, gy1, pj, x & 1, acc);  // TL (assigned) or TR
    C::bins(gx2, gy2, pj, false, acc);  // BL or BR
    if (!(x & 1)) {
#pragma unroll
      for (int k = 0; k < kBins; ++k)
        v[k][(x - 1) >> 1] = __fmul_rn(acc[k], 0.25f);
    }
  }
  return fin;
}

// ---- staging -----------------------------------------------------------

// Stage rows row0 .. row0+kRows-1 of kPlanes (H, W) planes of kIn-byte
// elements (plane stride H*W), columns col0 .. col0 + kCols - 1 (col0 *
// kIn a multiple of 16), into shared rows kDstRow bytes apart, 4-byte
// words, elements off the canvas 0: cp.async where the row is
// word-aligned (`async`; complete with the caller's next commit group),
// otherwise one or two aligned loads and a funnel shift, element by
// element at the canvas edges.  A thread takes 16 bytes at a time.
template <int kIn, int kCols, int kRows, int kPlanes, int kDstRow>
__device__ void stage(uint8_t* __restrict__ dst,
                      const uint8_t* __restrict__ src, int H, int W, int row0,
                      int col0, bool async) {
  constexpr int kChunk = 16 / kIn;  // elements of a 16-byte chunk
  constexpr int kChunks = kCols * kIn / 16;
  static_assert(kCols * kIn % 16 == 0, "staged rows are 16-byte chunks");
  const size_t plane = static_cast<size_t>(H) * W;
  constexpr int n = kPlanes * kRows * kChunks;
  for (int idx = threadIdx.y * kBX + threadIdx.x; idx < n; idx += kThreads) {
    const int pr = idx / kChunks, s = idx - pr * kChunks;
    const int pl = pr / kRows, gi = row0 + (pr - pl * kRows);
    const int c = col0 + kChunk * s;
    uint8_t* d = dst + pr * kDstRow + 16 * s;
    const bool row_in = gi >= 0 && gi < H;
    const uint8_t* row =
        src + (pl * plane + static_cast<size_t>(row_in ? gi : 0) * W) * kIn;
    constexpr int kPer = 4 / kIn;  // elements of a word
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cw = c + kPer * k;
      uint32_t* dw = reinterpret_cast<uint32_t*>(d) + k;
      uint32_t w = 0;
      if (row_in && cw >= 0 && cw + kPer <= W) {
        const uint8_t* at = row + static_cast<size_t>(cw) * kIn;
        if (async) {
          cp_async4(dw, at);
          continue;
        }
        // aligned words holding an in-bounds byte lie inside the buffer
        const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 3u);
        const uint32_t* q = reinterpret_cast<const uint32_t*>(at - mis);
        const uint32_t lo = __ldg(q);
        w = mis ? __funnelshift_r(lo, __ldg(q + 1), 8 * mis) : lo;
      } else if (row_in) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if (cw + e >= 0 && cw + e < W) {
            uint32_t x = 0;
            const uint8_t* at = row + static_cast<size_t>(cw + e) * kIn;
#pragma unroll
            for (int bb = 0; bb < kIn; ++bb)
              x |= static_cast<uint32_t>(at[bb]) << (8 * bb);
            w |= x << (8 * kIn * e);
          }
      }
      *dw = w;
    }
  }
}

// Four channel values of one output row at out + f (columns j0..j0+3 of a
// row W wide): one 16-byte (float) or 8-byte (bfloat16) store where
// aligned and inside the row; bfloat16 rounds to nearest even.
__device__ __forceinline__ void store4(float* __restrict__ out, size_t f,
                                       int j0, int W, const float (&v)[4]) {
  if (j0 + 4 <= W && (reinterpret_cast<uintptr_t>(out + f) & 15u) == 0) {
    *reinterpret_cast<float4*>(out + f) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (j0 + g < W) out[f + g] = v[g];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ out,
                                       size_t f, int j0, int W,
                                       const float (&v)[4]) {
  if (j0 + 4 <= W && (reinterpret_cast<uintptr_t>(out + f) & 7u) == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + f) = w;
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (j0 + g < W) out[f + g] = __float2bfloat16_rn(v[g]);
  }
}

// The pooled bins of one pooled row's four pixels of this thread at local
// row il: B2d passes from bits, recomputed with the reference's
// conversions when an element or gradient is not finite.
template <class T, int kIn, int kChain>
__device__ __forceinline__ void pooled_row(const uint8_t* sP, int il, int tx,
                                           const Proj& pj,
                                           float (&v)[kBins][4]) {
  Row<kIn> rows[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    rows[r] = image_row<T, kIn>(sP, 2 * il - 1 + r, tx);
  if constexpr (kChain == kFloat) {
    float fin = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 10; ++c) fin = __fmaf_rn(rows[r].get(c), 0.0f, fin);
    fin = __fadd_rn(fin, pass<FloatChain<true>>(rows, pj, v));
    if (fin != 0.0f) pass<FloatChain<false>>(rows, pj, v);
  } else {
    pass<FastChain<Elem<kIn>>>(rows, pj, v);
  }
}

// The bins of one pooled pixel from its 4 x 4 image pixels p (rows 2i-1
// .. 2i+2, columns 2j-1 .. 2j+2) through chain C, pooled; returns the
// gradients' sum of g * 0 where C checks them (0 while all are finite).
template <class C, class G>
__device__ __forceinline__ float cell_bins(const G (&e)[4][4], const Proj& pj,
                                           float (&v)[kBins]) {
  typename C::W p[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[r][c] = C::widen(e[r][c]);
  float fin = 0.0f;
  // phase a * 2 + q: image pixel (1 + a, 1 + q) of p, in the pool's order
  // TL, BL, TR, BR
  const int order[4] = {0, 2, 1, 3};
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int y = 1 + (order[o] >> 1), x = 1 + (order[o] & 1);
    const auto gx =
        C::sub(C::tap(p[y - 1][x - 1], p[y][x - 1], p[y + 1][x - 1]),
               C::tap(p[y - 1][x + 1], p[y][x + 1], p[y + 1][x + 1]));
    const auto gy =
        C::sub(C::tap(p[y - 1][x - 1], p[y - 1][x], p[y - 1][x + 1]),
               C::tap(p[y + 1][x - 1], p[y + 1][x], p[y + 1][x + 1]));
    if constexpr (C::kCheck) {
      fin = __fmaf_rn(gx, 0.0f, fin);
      fin = __fmaf_rn(gy, 0.0f, fin);
    }
    C::bins(gx, gy, pj, o == 0, v);
  }
#pragma unroll
  for (int k = 0; k < kBins; ++k) v[k] = __fmul_rn(v[k], 0.25f);
  return fin;
}

// The pooled bins of one pixel at local (il, jl), jl = -1 or kTW, from the
// staged planes (the smooth's ring columns), 0 off the canvas, into ring
// (k, il + 1, jl == kTW); B2d from bits as the passes.
template <class T, int kIn, int kChain>
__device__ void ring_cell(const uint8_t* sP, float* ring, int il, int jl,
                          bool inside, const Proj& pj) {
  Elem<kIn> e[4][4];
  float fin = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int Y = 2 * il - 1 + r, X = 2 * jl - 1 + c;  // local image px
      e[r][c] = elem_of<kIn>(raw_at<kIn>(staged_row<T, kIn>(sP, Y, X & 1),
                                         (X >> 1) + kPad<kIn>));
      if constexpr (kChain == kFloat) fin = __fmaf_rn(e[r][c], 0.0f, fin);
    }
  float v[kBins];
  if constexpr (kChain == kFloat) {
    fin = __fadd_rn(fin, cell_bins<FloatChain<true>>(e, pj, v));
    if (fin != 0.0f) cell_bins<FloatChain<false>>(e, pj, v);
  } else {
    cell_bins<FastChain<Elem<kIn>>>(e, pj, v);
  }
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    ring[(k * T::kPoolRows + il + 1) * 2 + (jl == kTW)] =
        inside ? v[k] : 0.0f;
}

template <int kChain>
using OutT = std::conditional_t<kChain == kFast, __nv_bfloat16, float>;

// kIn: bytes of a plane element (1 uint8, 2 bfloat16, 4 float32); kChain:
// kFloat (float32 planes) or kFast (any; the f32 chain and a bfloat16
// canvas).  tma: an item's planes come in by one tile load of pmap (the
// planes as a (4B, H, W) tensor, boxes of 4 planes x 18 rows x (kTW + 2
// kPad) columns; planes and base on 16 bytes), else by words; mask_tma:
// its mask by one of mmap ((H, W), boxes of kTH x kTW), else by words.
template <bool kSmooth, int kIn, int kChain>
__global__ void
__launch_bounds__(kThreads, (kBlocksOf<kSmooth, kChain, kIn>))
grad_hist_float_kernel(const __grid_constant__ CUtensorMap pmap,
                       const __grid_constant__ CUtensorMap mmap,
                       const uint8_t* __restrict__ planes,
                       const uint8_t* __restrict__ mask,
                       OutT<kChain>* __restrict__ out, int batch, int H,
                       int W, int tiles_x, int tiles_y, bool tma,
                       bool mask_tma, Proj pj) {
  static_assert(kChain != kFloat || kIn == 4, "B2d takes float32 planes");
  constexpr int kBufs = kBufsOf<kSmooth>;
  using T = Tile<kSmooth, kIn, kBufs>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* sPo = reinterpret_cast<float*>(smem);
  float* sRing = reinterpret_cast<float*>(smem + T::kPooled);
  uint8_t* sM = smem + T::kPooled + T::kRing;  // two masks
  uint8_t* sPbuf = sM + 2 * T::kMask;          // kBufs plane buffers
  uint64_t* bar = reinterpret_cast<uint64_t*>(sPbuf + kBufs * T::kPlanes);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool lead = tx == 0 && ty == 0;
  const size_t plane = static_cast<size_t>(H) * W;
  const bool async = (static_cast<size_t>(W) * kIn) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(planes) % 4 == 0;
  constexpr uint32_t kTx = T::kPlanes;  // bytes of one item's plane box

  // this block's run of items (tile-major, images fastest)
  const long long n_items = static_cast<long long>(tiles_x) * tiles_y * batch;
  const long long lo = n_items * blockIdx.x / gridDim.x;
  const long long hi = n_items * (blockIdx.x + 1) / gridDim.x;

  // start the copies of item `it`: planes into buffer pb (TMA: completing
  // on bar[pb]), its mask into mask buffer mb
  auto fetch = [&](long long it, int pb, int mb) {
    const long long tile = it / batch;
    const int b = static_cast<int>(it - tile * batch);
    const int I0 = static_cast<int>(tile / tiles_x) * T::kTH;
    const int J0 = static_cast<int>(tile % tiles_x) * kTW;
    if (tma) {
      if (lead) {
        fence_proxy_async();
        mbar_expect_tx(bar + pb, kTx + (kSmooth && mask_tma ? T::kMask : 0));
        tma_load_3d(sPbuf + pb * T::kPlanes, &pmap, J0 - kPad<kIn>,
                    I0 - T::kRow0, 4 * b, bar + pb);
        if (kSmooth && mask_tma)
          tma_load_2d(sM + mb * T::kMask, &mmap, J0, I0, bar + pb);
      }
    } else {
      stage<kIn, kTW + 2 * kPad<kIn>, T::kPlaneRows, 4, kRowBytes<kIn>>(
          sPbuf + pb * T::kPlanes,
          planes + static_cast<size_t>(b) * 4 * plane * kIn, H, W,
          I0 - T::kRow0, J0 - kPad<kIn>, async);
    }
    if (kSmooth && !(tma && mask_tma))
      stage<1, kTW, T::kTH, 1, kTW>(sM + mb * T::kMask, mask, H, W, I0, J0,
                                    false);
  };

  if (tma && lead) {
    for (int k = 0; k < kBufs; ++k) mbar_init(bar + k, 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (lo < hi) fetch(lo, 0, 0);
  cp_async_commit();
  uint32_t phase = 0;  // the parity each buffer's barrier completes next
  int pb = 0;
  for (long long it = lo; it < hi; ++it) {
    const int mb = static_cast<int>((it - lo) & 1);
    __syncthreads();  // the previous item is done with sPo, other buffer
    if constexpr (kBufs == 2) {
      if (it + 1 < hi) fetch(it + 1, pb ^ 1, mb ^ 1);
      cp_async_commit();
    }
    if (tma) {
      mbar_wait(bar + pb, (phase >> pb) & 1u);
      phase ^= 1u << pb;
    } else {
      cp_async_wait<kBufs - 1>();  // this item's copies are in
      __syncthreads();
    }
    const long long tile = it / batch;
    const int b = static_cast<int>(it - tile * batch);
    const int I0 = static_cast<int>(tile / tiles_x) * T::kTH;
    const int J0 = static_cast<int>(tile % tiles_x) * kTW;
    const int j0 = J0 + 4 * tx;
    const uint8_t* sP = sPbuf + pb * T::kPlanes;
    auto* dst = out + static_cast<size_t>(b) * kBins * plane;

    // two adjacent pooled rows: 0 .. kTH-1, with the smooth -1 .. kTH
#pragma unroll 1
    for (int rr = 0; rr < 2; ++rr) {
      const int il = 2 * ty + rr - (kSmooth ? 1 : 0);
      const int i = I0 + il;
      float v[kBins][4];
      pooled_row<T, kIn, kChain>(sP, il, tx, pj, v);
      if (kSmooth) {
        const bool row_in = i >= 0 && i < H;
#pragma unroll
        for (int k = 0; k < kBins; ++k) {
          float4 q;
          q.x = row_in && j0 < W ? v[k][0] : 0.0f;
          q.y = row_in && j0 + 1 < W ? v[k][1] : 0.0f;
          q.z = row_in && j0 + 2 < W ? v[k][2] : 0.0f;
          q.w = row_in && j0 + 3 < W ? v[k][3] : 0.0f;
          *reinterpret_cast<float4*>(
              sPo + (k * T::kPoolRows + il + 1) * kTW + 4 * tx) = q;
        }
      } else if (i < H) {
#pragma unroll
        for (int k = 0; k < kBins; ++k)
          store4(dst, static_cast<size_t>(k) * plane +
                          static_cast<size_t>(i) * W + j0, j0, W, v[k]);
      }
    }

    if (kSmooth && tx < 4) {
      // the pooled ring columns -1 and kTW of this warp's two rows
      const int il = 2 * ty - 1 + (tx >> 1), jl = (tx & 1) ? kTW : -1;
      const int i = I0 + il, j = J0 + jl;
      ring_cell<T, kIn, kChain>(sP, sRing, il, jl,
                                i >= 0 && i < H && j >= 0 && j < W, pj);
    }
    if constexpr (kBufs == 1) {
      __syncthreads();  // the planes are read: copy the next item's in
      if (it + 1 < hi) fetch(it + 1, 0, mb ^ 1);
      cp_async_commit();
    } else if (kSmooth) {
      __syncthreads();
    }
    pb ^= kBufs - 1;
    if (!kSmooth) continue;

    // the smooth, two adjacent rows a warp
    const uint32_t* sI = reinterpret_cast<const uint32_t*>(sM + mb * T::kMask);
    const int il0 = 2 * ty;
    if (il0 >= T::kTH || I0 + il0 >= H) continue;  // warp-uniform
    const bool second = il0 + 1 < T::kTH && I0 + il0 + 1 < H;
    const uint32_t in0 = sI[il0 * (kTW / 4) + tx];
    const uint32_t in1 = second ? sI[(il0 + 1) * (kTW / 4) + tx] : 0u;
#pragma unroll
    for (int k = 0; k < kBins; ++k) {
      // pooled rows il0-1 .. il0+2, columns -1 .. 4 of this thread
      float p[4][6];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pr = k * T::kPoolRows + il0 + r;
        const float4 c = *reinterpret_cast<const float4*>(
            sPo + pr * kTW + 4 * tx);
        const float left = __shfl_up_sync(0xffffffffu, c.w, 1);
        const float right = __shfl_down_sync(0xffffffffu, c.x, 1);
        p[r][0] = tx == 0 ? sRing[2 * pr] : left;
        p[r][1] = c.x;
        p[r][2] = c.y;
        p[r][3] = c.z;
        p[r][4] = c.w;
        p[r][5] = tx == kBX - 1 ? sRing[2 * pr + 1] : right;
      }
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (o == 1 && !second) break;
        const uint32_t in = o ? in1 : in0;
        float sm[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = p[o][g];
          s = __fmaf_rn(2.0f, p[o][g + 1], s);
          s = __fadd_rn(s, p[o][g + 2]);
          s = __fmaf_rn(2.0f, p[o + 1][g], s);
          s = __fmaf_rn(4.0f, p[o + 1][g + 1], s);
          s = __fmaf_rn(2.0f, p[o + 1][g + 2], s);
          s = __fadd_rn(s, p[o + 2][g]);
          s = __fmaf_rn(2.0f, p[o + 2][g + 1], s);
          s = __fadd_rn(s, p[o + 2][g + 2]);
          sm[g] = ((in >> (8 * g)) & 255u) ? __fmul_rn(s, 0.0625f) : 0.0f;
        }
        store4(dst, static_cast<size_t>(k) * plane +
                        static_cast<size_t>(I0 + il0 + o) * W + j0, j0, W,
               sm);
      }
    }
  }
}

// Blocks of an instance that the card holds at once (one wave), queried
// once per device and kernel after the opt-in to dynamic shared memory
// above 48 KB; 0 and the error on failure.
std::pair<int, int> wave(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, std::pair<int, int>> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find({dev, kernel});
  if (it != seen.end()) return it->second;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int n = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      bytes);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return {0, static_cast<int>(e)};
  if (n < 1) return {0, static_cast<int>(cudaErrorInvalidConfiguration)};
  return seen[{dev, kernel}] = {n * sms, 0};
}

template <bool kSmooth, int kIn, int kChain>
int launch(const void* planes, const uint8_t* mask, void* out, int batch,
           int H, int W, const Proj& pj, cudaStream_t stream) {
  using T = Tile<kSmooth, kIn, kBufsOf<kSmooth>>;
  const auto kernel = grad_hist_float_kernel<kSmooth, kIn, kChain>;
  const int bytes = static_cast<int>(T::kBytes) + 16;  // + the mbarriers
  const auto [slots, err] =
      wave(reinterpret_cast<const void*>(kernel), bytes);
  if (err) return err;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + T::kTH - 1) / T::kTH;
  const long long items = static_cast<long long>(tiles_x) * tiles_y * batch;
  const int grid = static_cast<int>(items < slots ? items : slots);
  // tile loads where every plane row and the base lie on 16 bytes
  const bool vec = (static_cast<size_t>(W) * kIn) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  CUtensorMap pmap{}, mmap{};
  bool tma = false, mask_tma = false;
  if (vec) {
    const cuuint64_t pd[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              4 * static_cast<cuuint64_t>(batch)};
    const cuuint32_t pbox[3] = {kTW + 2 * kPad<kIn>, T::kPlaneRows, 4};
    tma = tensor_map(&pmap, planes, kIn, 3, pd, pbox);
    const cuuint64_t md[2] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H)};
    const cuuint32_t mbox[2] = {kTW, T::kTH};
    mask_tma = tma && kSmooth && W % 16 == 0 &&
               reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
               tensor_map(&mmap, mask, 1, 2, md, mbox);
  }
  kernel<<<grid, dim3(kBX, kBY), bytes, stream>>>(
      pmap, mmap, static_cast<const uint8_t*>(planes), mask,
      static_cast<OutT<kChain>*>(out), batch, H, W, tiles_x, tiles_y, tma,
      mask_tma, pj);
  return 0;
}

// The four bins' constants; bin 0 must be cos 1, sin 0 (its value is
// |gx|), and B2f's f32 roundings must have the identities its shared
// products use.
bool projections(const double* cos4, const double* sin4, Proj* pj) {
  if (cos4[0] != 1.0 || sin4[0] != 0.0) return false;
  for (int k = 0; k < kBins; ++k) {
    pj->c[k] = cos4[k];
    pj->s[k] = sin4[k];
    pj->cu[k] = cos4[k] * 0x1p896;  // exact: a power of two
    pj->su[k] = sin4[k] * 0x1p896;
    pj->cf[k] = static_cast<float>(cos4[k]);  // round to nearest even
    pj->sf[k] = static_cast<float>(sin4[k]);
  }
  const float* c = pj->cf;
  const float* sn = pj->sf;
  return sn[1] == c[1] && sn[3] == c[1] && c[3] == -c[1] && sn[2] == 1.0f;
}

}  // namespace

// B2d.  planes (B, 2, 2, H, W) float32, out (B, 4, H, W) float32; cos4 /
// sin4: the four bins' cos and sin.
extern "C" int wb_grad_hist_float(const void* planes, const void* mask,
                                  void* out, int batch, int H, int W,
                                  int smooth, const double* cos4,
                                  const double* sin4, void* stream) {
  Proj pj;
  if (!projections(cos4, sin4, &pj))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && H > 0 && W > 0) {
    const auto* m = static_cast<const uint8_t*>(mask);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int e = smooth ? launch<true, 4, kFloat>(planes, m, out, batch, H,
                                                   W, pj, st)
                         : launch<false, 4, kFloat>(planes, m, out, batch, H,
                                                    W, pj, st);
    if (e) return e;
  }
  return static_cast<int>(cudaGetLastError());
}

// B2f.  planes (B, 2, 2, H, W) of elem_bytes-byte elements (1 uint8, 2
// bfloat16, 4 float32), out (B, 4, H, W) bfloat16.
extern "C" int wb_grad_hist_fast(const void* planes, const void* mask,
                                 void* out, int batch, int H, int W,
                                 int smooth, int elem_bytes,
                                 const double* cos4, const double* sin4,
                                 void* stream) {
  Proj pj;
  if ((elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4) ||
      !projections(cos4, sin4, &pj))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && H > 0 && W > 0) {
    const auto* m = static_cast<const uint8_t*>(mask);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int e;
    if (smooth)
      e = elem_bytes == 1   ? launch<true, 1, kFast>(planes, m, out, batch, H,
                                                    W, pj, st)
          : elem_bytes == 2 ? launch<true, 2, kFast>(planes, m, out, batch, H,
                                                    W, pj, st)
                            : launch<true, 4, kFast>(planes, m, out, batch, H,
                                                    W, pj, st);
    else
      e = elem_bytes == 1   ? launch<false, 1, kFast>(planes, m, out, batch,
                                                     H, W, pj, st)
          : elem_bytes == 2 ? launch<false, 2, kFast>(planes, m, out, batch,
                                                     H, W, pj, st)
                            : launch<false, 4, kFast>(planes, m, out, batch,
                                                     H, W, pj, st);
    if (e) return e;
  }
  return static_cast<int>(cudaGetLastError());
}
