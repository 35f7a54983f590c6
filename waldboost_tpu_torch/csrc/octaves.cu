// S4: the octave chain of a batch of frames, every octave of every frame
// written in one launch into the (B, S) octave buffer that B1 reads.
//
//  wb_octaves  per frame of a (B, H, W) uint8 or float32 batch: octave 0
//              is the frame, octave k + 1 the 2x2 average of octave k's
//              blocks, an odd last row or column dropped (H_{k+1} =
//              H_k / 2, W_{k+1} = W_k / 2).  Octave k is written row-major
//              at offset off_k of its frame's row of S = sum H_k * W_k
//              values: byte for byte ops/planes.py::octave_buffer of
//              channels.py::level_octaves (uint8 or float32).
//
// Replaces no TPU kernel: the JAX package builds its octaves in XLA
// (waldboost_tpu/channels.py::_compute_octaves_f32, :517).  The port's
// plain version made 7 launches an octave through int32 temporaries four
// bytes a pixel wide, then one torch.cat that copied octave 0 again: 29
// launches a VGA batch (5 octaves) and 43 a 4K batch (7 octaves), about
// 0.98 device ms a 4K batch of 8 on the H100.
//
// Bitwise the plain chain:
//  - uint8: ((tl + bl) % 256 + (tr + br) % 256) % 256 // 4 equals
//    ((tl + bl + tr + br) & 255) >> 2, one add chain in registers (four
//    outputs at a time in 16-bit lanes of a word).  Each octave is still
//    computed from the previous one: the floor at each step does not
//    collapse across steps.
//  - float32: (((tl + bl) + tr) + br) / 4, each add rounded on its own in
//    that order (__fadd_rn; the library builds with -fmad=false too), the
//    quarter an exact multiply (x * 0.25 rounds as x / 4 on every float,
//    subnormals included).  NaN and inf pass through as in torch.
//
// Design: a block of 256 threads owns one frame's aligned region of 64
// rows of 256 bytes of the launch's first octave (64 x 256 uint8, 64 x 64
// float32).  Pixel (i, j) of octave k depends only on the aligned
// 2^k x 2^k block of the first octave beneath it, and exists iff i < H_k
// and j < W_k; the four sources of a pixel that exists exist too.  So
// regions are independent, and edge regions only mask their stores.
//  - Loads: the region once, four 16-byte loads a thread issued together
//    (16 KB in flight a block), where the frame's rows and frames start on
//    16 bytes; else value by value.  A 64 x 64 uint8 tile with one load a
//    thread reached 0.46 of the bound at 4K.
//  - Octave 0's slot: the frame offset b * S is only 4-byte aligned at 4K
//    (S = 11,058,420), and stores that follow the region's rows leave an
//    unaligned head and tail on every row: 0.081 ms a 4K batch, against
//    0.058 with every frame's slot aligned (H100).  But a frame lies in
//    its slot as in the frame, flat, shifted by the slot's address mod 16
//    (m).  So each row also loads the 16 bytes before it in the frame and
//    stores the aligned window m bytes before its own bytes; the windows
//    of consecutive rows tile the slot, and only its first 16 - m and last
//    m bytes are stored narrowly: 0.069 ms.  The rest of the gap lies in
//    octaves 1-6, whose rows' ends stay unaligned.
//  - Octaves 1-6: the region halved level by level in shared memory
//    (22,868 bytes for either type), each level stored to its octave's
//    slot (uint8: four values a thread and step, one 4-byte store where
//    aligned).  64 rows cover octaves 1-6, all that VGA (5 octaves) and 4K
//    (7) need; a frame that needs more runs the kernel again over octave 6
//    of the buffer (first = 1: its first octave is not written again), a
//    tiny tail.
//
// Bound on the H100: bytes.  Each frame value read once and the buffer
// written once: 154.8 MB a 4K batch of 8 (0.046 ms at 3.35 TB/s), 5.7 MB
// a VGA batch (1.7 us), where the one launch is the cost.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLevels = 7;      // octaves a launch writes: 64 rows halve 6x
constexpr int kRows = 64;       // first-octave rows of a block
constexpr int kRowBytes = 256;  // first-octave bytes of a block's row
constexpr int kThreads = 256;
constexpr int kRowChunks = kRowBytes / 16;                 // 16
constexpr int kPerThread = kRows * kRowChunks / kThreads;  // 4

// A row of the first octave in shared memory: the 16 bytes before the
// region's row in the frame, then the region's 256.
constexpr int kLead = 16;
constexpr int kStride = kLead + kRowBytes;

template <typename T>
struct Region {
  static constexpr int kCols = kRowBytes / sizeof(T);
  static constexpr int kLogCols = sizeof(T) == 1 ? 8 : 6;
  // the first octave's rows, then its six halvings of the region
  static constexpr int kSmem = (kRows * kStride + (kRows * kRowBytes >> 2) +
                                (kRows * kRowBytes >> 4) +
                                (kRows * kRowBytes >> 6) +
                                (kRows * kRowBytes >> 8) +
                                (kRows * kRowBytes >> 10) +
                                (kRows * kRowBytes >> 12)) / sizeof(T);
};

struct Args {
  const void* in;       // the launch's first octave, rows of w[0] values
  long long in_frame;   // values from one frame's first octave to the next
  void* out;            // (B, out_frame) octave buffer
  long long out_frame;  // S
  long long off[kLevels];  // the launch's octave k at off[k] of a frame
  int h[kLevels], w[kLevels];
  int n_levels;  // octaves of this launch, 1..kLevels
  int first;     // first octave written: 0, or 1 where it is in out already
  int tiles_x, tiles_y;
  int vec_in;    // 16-byte loads: in, its rows and its frames on 16 bytes
};

// Four uint8 outputs from 8 bytes of each of two rows: output p is
// ((top[2p] + top[2p+1] + bot[2p] + bot[2p+1]) & 255) >> 2, summed in the
// 16-bit lanes of a word (at most 1020: no carry between lanes).
__device__ __forceinline__ uint32_t pool4(uint2 top, uint2 bot) {
  constexpr uint32_t m = 0x00ff00ffu;
  const uint32_t lo = ((top.x & m) + ((top.x >> 8) & m) + (bot.x & m) +
                       ((bot.x >> 8) & m)) & m;
  const uint32_t hi = ((top.y & m) + ((top.y >> 8) & m) + (bot.y & m) +
                       ((bot.y >> 8) & m)) & m;
  return __byte_perm((lo >> 2) & 0x003f003fu, (hi >> 2) & 0x003f003fu,
                     0x6420);
}

// The float32 2x2 average of (tl, tr) over (bl, br) as the chain computes it.
__device__ __forceinline__ float pool(float2 top, float2 bot) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(top.x, bot.x), top.y),
                             bot.y),
                   0.25f);
}

// 16 bytes from shared memory at any address.
__device__ __forceinline__ uint4 read16(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15u) == 0) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
  if ((a & 3u) == 0) {
    for (int i = 0; i < 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
    for (int i = 0; i < 4; ++i)
      w[i] = p[4 * i] | p[4 * i + 1] << 8 | p[4 * i + 2] << 16 |
             static_cast<uint32_t>(p[4 * i + 3]) << 24;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// n bytes from shared memory to global memory: words where both lie on 4
// bytes, else bytes.
__device__ __forceinline__ void copy_bytes(uint8_t* d, const uint8_t* p,
                                           int n) {
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(p) |
        n) & 3u) == 0) {
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<uint32_t*>(d + i) =
          *reinterpret_cast<const uint32_t*>(p + i);
  } else {
    for (int i = 0; i < n; ++i) d[i] = p[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) octaves_kernel(Args a) {
  using R = Region<T>;
  __shared__ __align__(16) T s[R::kSmem];
  constexpr int kVec = 16 / sizeof(T);  // values in 16 bytes
  const int tx = blockIdx.x % a.tiles_x;
  const int rest = blockIdx.x / a.tiles_x;
  const int ty = rest % a.tiles_y;
  const long long b = rest / a.tiles_y;
  const T* in = static_cast<const T*>(a.in) + b * a.in_frame;
  T* out = static_cast<T*>(a.out) + b * a.out_frame;
  const int H = a.h[0], W = a.w[0];
  const int y0 = ty * kRows, x0 = tx * R::kCols;

  // the first octave into shared memory, each row after the 16 bytes
  // before it in the frame (0 outside the frame: never the source of a
  // value written)
  uint8_t* s8 = reinterpret_cast<uint8_t*>(s);
  if (a.vec_in) {
    // W is a multiple of kVec: a chunk lies wholly in or out
    uint4 v[kPerThread], lead;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const int y = y0 + q / kRowChunks;
      const int x = x0 + q % kRowChunks * kVec;
      v[u] = y < H && x < W ? *reinterpret_cast<const uint4*>(
                                  in + static_cast<long long>(y) * W + x)
                            : make_uint4(0u, 0u, 0u, 0u);
    }
    const long long f = static_cast<long long>(y0 + threadIdx.x) * W + x0;
    const bool has_lead = threadIdx.x < kRows && y0 + threadIdx.x < H &&
                          f > 0;
    lead = has_lead ? *reinterpret_cast<const uint4*>(in + f - kVec)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int q = threadIdx.x + u * kThreads;
      *reinterpret_cast<uint4*>(s8 + q / kRowChunks * kStride + kLead +
                                q % kRowChunks * 16) = v[u];
    }
    if (threadIdx.x < kRows)
      *reinterpret_cast<uint4*>(s8 + threadIdx.x * kStride) = lead;
  } else {
    for (int q = threadIdx.x; q < kRows * R::kCols; q += kThreads) {
      const int y = y0 + (q >> R::kLogCols);
      const int x = x0 + (q & (R::kCols - 1));
      reinterpret_cast<T*>(s8 + (q >> R::kLogCols) * kStride + kLead)[
          q & (R::kCols - 1)] =
          y < H && x < W ? in[static_cast<long long>(y) * W + x] : T(0);
    }
  }
  __syncthreads();

  if (a.first == 0 && a.vec_in) {
    // octave 0's slot in aligned 16-byte chunks.  Its first octave lies
    // in the buffer as in the frame, flat: a frame's slot is its bytes
    // shifted by m = (slot address) mod 16 bytes.  So each row of the
    // region writes the aligned window m bytes before its own bytes (the
    // lead holds them), the windows of consecutive rows tile the slot, and
    // only the slot's first 16 - m bytes and its last m bytes are written
    // narrowly.
    T* slot = out + a.off[0];
    const int m = static_cast<int>(reinterpret_cast<uintptr_t>(slot) & 15u);
    const int len = min(R::kCols, W - x0) * static_cast<int>(sizeof(T));
    const long long end = static_cast<long long>(H) * W * sizeof(T);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const int r = q / kRowChunks, c = q % kRowChunks;
      if (y0 + r >= H || 16 * c >= len) continue;
      // the row's first byte in the slot, and the chunk's
      const long long fb =
          (static_cast<long long>(y0 + r) * W + x0) * sizeof(T);
      const long long at = fb - m + 16 * c;
      uint8_t* d = reinterpret_cast<uint8_t*>(slot) + at;
      const uint8_t* p = s8 + r * kStride + kLead - m + 16 * c;
      if (at >= 0)
        *reinterpret_cast<uint4*>(d) = read16(p);
      else  // the slot's first chunk: its bytes from the slot's start
        copy_bytes(d + m, p + m, 16 - m);
      if (fb + len == end && 16 * c + 16 == len)  // the slot's last m bytes
        copy_bytes(d + 16, p + 16, m);
    }
  } else if (a.first == 0) {
    for (int q = threadIdx.x; q < kRows * R::kCols; q += kThreads) {
      const int y = y0 + (q >> R::kLogCols);
      const int x = x0 + (q & (R::kCols - 1));
      if (y < H && x < W)
        out[a.off[0] + static_cast<long long>(y) * W + x] =
            reinterpret_cast<const T*>(s8 + (q >> R::kLogCols) * kStride +
                                       kLead)[q & (R::kCols - 1)];
    }
  }

  // each further octave from the previous one in shared memory
  T* prev = reinterpret_cast<T*>(s8 + kLead);
  int pw = kStride / sizeof(T);  // the previous octave's row stride
  T* cur = reinterpret_cast<T*>(s8 + kRows * kStride);
  for (int k = 1; k < a.n_levels; ++k) {
    const int mh = kRows >> k;
    const int lw = R::kLogCols - k, mw = 1 << lw;
    const int Hk = a.h[k], Wk = a.w[k];
    const int yk = ty * mh, xk = tx * mw;
    // the same in every thread: no pixel of this octave or a later one
    // lies in the region
    if (yk >= Hk || xk >= Wk) break;
    T* dst = out + a.off[k];
    if constexpr (sizeof(T) == 1) {
      const int lg = lw - 2;  // four outputs a step: mw / 4 steps a row
      for (int p = threadIdx.x; p < mh << lg; p += kThreads) {
        const int i = p >> lg, j = (p & ((1 << lg) - 1)) << 2;
        const uint8_t* src = prev + 2 * i * pw + 2 * j;
        const uint32_t word =
            pool4(*reinterpret_cast<const uint2*>(src),
                  *reinterpret_cast<const uint2*>(src + pw));
        *reinterpret_cast<uint32_t*>(cur + i * mw + j) = word;
        const int gi = yk + i, gj = xk + j;
        if (gi >= Hk) continue;
        uint8_t* d = dst + static_cast<long long>(gi) * Wk + gj;
        if (gj + 4 <= Wk && (reinterpret_cast<uintptr_t>(d) & 3u) == 0) {
          *reinterpret_cast<uint32_t*>(d) = word;
        } else {
          for (int e = 0; e < 4 && gj + e < Wk; ++e)
            d[e] = static_cast<uint8_t>(word >> (8 * e));
        }
      }
    } else {
      for (int p = threadIdx.x; p < mh << lw; p += kThreads) {
        const int i = p >> lw, j = p & (mw - 1);
        const T* src = prev + 2 * i * pw + 2 * j;
        const T v = pool(*reinterpret_cast<const float2*>(src),
                         *reinterpret_cast<const float2*>(src + pw));
        cur[p] = v;
        if (yk + i < Hk && xk + j < Wk)
          dst[static_cast<long long>(yk + i) * Wk + xk + j] = v;
      }
    }
    __syncthreads();
    prev = cur;
    pw = mw;
    cur += mh * mw;
  }
}

}  // namespace

// S4: octaves first .. n_levels - 1 of a batch of `batch` frames into out.
// in: the first octave (h[0] x w[0] values a frame, rows contiguous,
// frames in_frame values apart); out: (batch, out_frame) values, octave k
// of a frame at off[k]; is_float: float32 values, else uint8.  One launch
// (none where the batch or the first octave is empty).
extern "C" int wb_octaves(const void* in, long long in_frame, void* out,
                          long long out_frame, const long long* off,
                          const int* h, const int* w, int n_levels,
                          int first, int batch, int is_float, void* stream) {
  if (n_levels < 1 || n_levels > kLevels || (first != 0 && first != 1) ||
      batch < 0 || h[0] < 0 || w[0] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.in = in;
  a.in_frame = in_frame;
  a.out = out;
  a.out_frame = out_frame;
  for (int k = 0; k < n_levels; ++k) {
    a.off[k] = off[k];
    a.h[k] = h[k];
    a.w[k] = w[k];
  }
  a.n_levels = n_levels;
  a.first = first;
  const int cols = is_float ? Region<float>::kCols : Region<uint8_t>::kCols;
  a.tiles_x = (w[0] + cols - 1) / cols;
  a.tiles_y = (h[0] + kRows - 1) / kRows;
  const long long blocks =
      static_cast<long long>(batch) * a.tiles_x * a.tiles_y;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const long long size = is_float ? 4 : 1;
    a.vec_in = (reinterpret_cast<uintptr_t>(in) & 15u) == 0 &&
               (w[0] * size) % 16 == 0 && (in_frame * size) % 16 == 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_float)
      octaves_kernel<float><<<static_cast<int>(blocks), kThreads, 0, st>>>(
          a);
    else
      octaves_kernel<uint8_t><<<static_cast<int>(blocks), kThreads, 0, st>>>(
          a);
  }
  return static_cast<int>(cudaGetLastError());
}
