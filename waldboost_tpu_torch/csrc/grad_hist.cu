// grad_hist channel canvas from uint8 polyphase planes (B2, wb_grad_hist):
// gradients, oriented projections, 2x2 average pool, 3x3/16 smooth,
// interior mask, the exact chain with an f32 canvas.  The float- and
// fast-mode chains B2d and B2f are csrc/grad_hist_float.cu.
//
// Replaces: waldboost_tpu/ops/channels_pallas.py::grad_hist_poly_pallas
// (body _make_kernel, tile fetch _db_fetch), the exact uint8 variant.  On
// the TPU the f64-rounded projection f32(f64(gx*cos - gy*sin)) is emulated
// by a verified f32 term plan; the H100 computes it in native f64.
//
// Bound on the H100: bytes.  Per pooled pixel the planes are read once (4
// bytes per image) and the interior mask once for the batch (smooth only),
// and 4 float32 channels are written (16 bytes).  Close behind are the
// instructions: per pooled pixel 4 phases x 4 bins of the projection, the
// gradients, the pool and the smooth.
//
// Design (the structure of csrc/fpga.cu): a block owns a 128 x 16 tile of
// channel pixels (14 with the smooth) and loops over the images of the
// batch (blockIdx.z, gridDim.z apart), so the interior mask is staged in
// shared memory once for all of them.  Staged tiles are grids of 32-bit
// words of 4 consecutive plane bytes, bytes off the canvas 0 (the zero
// fill of the JAX chain's _shift).  Where every plane row starts on a
// word, the planes of the block's next image are copied in by cp.async, a
// thread 4 words at a time, into a second buffer while the current image
// is computed; elsewhere each word is one or two aligned loads and a
// funnel shift, so any plane width and base address work.  Each thread
// computes 4 adjacent pooled pixels of two rows: the [1,2,1] prefilters of
// each image column once for its neighbours, the integer gradients, the
// four bins and the pool, and stores each channel as one 16-byte word
// where the address allows it.  With the smooth, the pooled rows above and
// below the tile are two more rows of the same pass (16 rows for 14), the
// 32 pooled ring-column cells a scalar pass, both 0 off the canvas, so the
// result holds for any mask; the smooth reads its column neighbours
// through warp shuffles.
//
// Exactness.  Every float and double operation is an explicitly rounded
// intrinsic (and the library is built with -fmad=false), in the reference's
// association: integer prefilters (a + 2b) + c and gradients (exact), each
// bin f32(f64(gx*cos - gy*sin)) in native f64, pool = (((TL + BL) + TR) +
// BR) * 0.25, smooth = 9 terms left to right, times 1/16, then mask ? v :
// 0 (a term 2p or 4p is exact, so it is fused into its add).

#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kTW = 128;               // output tile width (channel px)
constexpr int kBX = 32, kBY = 8;       // threads: 4 columns x 2 rows each
constexpr int kThreads = kBX * kBY;
constexpr int kRowElems = kTW + 8;     // staged row: local cols -4 .. kTW+3
constexpr int kWords = kRowElems / 4;  // words of a staged uint8 row
constexpr int kBins = 4;
constexpr int kBlocksPerSm = 5;        // 48 registers (sweep_torch_kernels)

// The tile of channel pixels of one block and its dynamic shared memory
// (32-bit words): the pooled tile and its ring columns (smooth only), two
// buffers of staged planes, the staged interior mask (smooth only).
template <bool kSmooth>
struct Tile {
  static constexpr int kTH = kSmooth ? 14 : 16;  // output rows
  static constexpr int kPlaneRows = kTH + 4;     // planes I0-2 .. I0+kTH+1
  static constexpr int kPoolRows = kTH + 2;      // pooled I0-1 .. I0+kTH
  static constexpr int kPooled = kSmooth ? kBins * kPoolRows * kTW : 0;
  static constexpr int kRing = kSmooth ? kBins * kPoolRows * 2 : 0;
  static constexpr int kPlanes = 4 * kPlaneRows * kWords;
  static constexpr int kMask = kSmooth ? kTH * kWords : 0;
  static constexpr size_t kBytes =
      4 * static_cast<size_t>(kPooled + kRing + 2 * kPlanes + kMask);
};

// cp.async of one 4-byte word from global to shared memory, and its groups.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one group (the newest) is in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Projection constants of the four bins.
struct Proj {
  double c[kBins];
  double s[kBins];
};

// An int32 as double, exactly: 2^52 + (v + 2^31) built from its bits, minus
// 2^52 + 2^31 (an f64 subtract instead of the slower conversion unit).
__device__ __forceinline__ double to_double(int v) {
  return __dsub_rn(__hiloint2double(0x43300000, v ^ 0x80000000),
                   4503601774854144.0);
}

// The [1,2,1] prefilter (a + 2b) + c, exact on integers.
__device__ __forceinline__ int tap3(int a, int b, int c) {
  return a + 2 * b + c;
}

// The four bins of one image pixel's gradients, added into acc (first:
// assigned), in the pool's phase order.
__device__ __forceinline__ void bins(int gx, int gy, const Proj& pj,
                                     bool first, float (&acc)[kBins]) {
  const double dx = to_double(gx), dy = to_double(gy);
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    const float b = fabsf(__double2float_rn(
        __dsub_rn(__dmul_rn(dx, pj.c[k]), __dmul_rn(dy, pj.s[k]))));
    acc[k] = first ? b : __fadd_rn(acc[k], b);
  }
}

// The pooled bins of a pooled pixel from its four phases' gradients
// (phase index a * 2 + q).
__device__ __forceinline__ void pool(const int (&gx)[4], const int (&gy)[4],
                                     const Proj& pj, float (&v)[kBins]) {
  bins(gx[0], gy[0], pj, true, v);   // TL (a 0, q 0)
  bins(gx[2], gy[2], pj, false, v);  // BL (a 1, q 0)
  bins(gx[1], gy[1], pj, false, v);  // TR (a 0, q 1)
  bins(gx[3], gy[3], pj, false, v);  // BR (a 1, q 1)
#pragma unroll
  for (int k = 0; k < kBins; ++k) v[k] = __fmul_rn(v[k], 0.25f);
}

__device__ __forceinline__ int byte_of(uint64_t v, int k) {
  return static_cast<int>((v >> (8 * k)) & 255u);
}

// One staged word: bytes c .. c+3 of a plane row (nullptr: off the
// canvas), bytes off the canvas 0; a cp.async copy when `async` and the
// word lies inside the row.
__device__ __forceinline__ void stage_word(uint32_t* dst, const uint8_t* row,
                                           int c, int W, bool async) {
  uint32_t w = 0;
  if (row != nullptr) {
    if (c >= 0 && c + 4 <= W) {
      if (async) {
        cp_async4(dst, row + c);
        return;
      }
      // aligned words holding an in-bounds byte lie inside the buffer
      const uintptr_t at = reinterpret_cast<uintptr_t>(row + c);
      const int mis = static_cast<int>(at & 3u);
      const uint32_t* p = reinterpret_cast<const uint32_t*>(at - mis);
      const uint32_t lo = __ldg(p);
      w = mis ? __funnelshift_r(lo, __ldg(p + 1), 8 * mis) : lo;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k >= 0 && c + k < W)
          w |= static_cast<uint32_t>(row[c + k]) << (8 * k);
    }
  }
  *dst = w;
}

// Stage rows row0 .. row0+kRows-1 of kPlanes (H, W) uint8 planes (plane
// stride H*W) as kWords words per row: a row holds columns col0 .. col0 +
// kRowElems - 1, bytes off the canvas 0.  With `async` (every row starts
// on a word, col0 a multiple of 4) the words inside the canvas are
// cp.async copies that complete with the caller's next commit group.  A
// thread takes 4 words of a row at a time.
template <int kPlanes, int kRows>
__device__ void stage(uint32_t* __restrict__ dst, const void* __restrict__ src,
                      int H, int W, int row0, int col0, bool async) {
  constexpr int kPer = 4, kW = kWords;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* s0 = static_cast<const uint8_t*>(src);
  constexpr int kQuads = (kW + 3) / 4;
  constexpr int n = kPlanes * kRows * kQuads;
  for (int idx = threadIdx.y * kBX + threadIdx.x; idx < n; idx += kThreads) {
    const int pr = idx / kQuads, s = 4 * (idx - pr * kQuads);
    const int pl = pr / kRows, gi = row0 + (pr - pl * kRows);
    const int c = col0 + kPer * s;
    const uint8_t* row = gi >= 0 && gi < H
                             ? s0 + pl * plane + static_cast<size_t>(gi) * W
                             : nullptr;
    uint32_t* d = dst + pr * kW + s;
    if (async && row != nullptr && s + 4 <= kW && c >= 0 &&
        c + 4 * kPer <= W) {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async4(d + k, row + c + kPer * k);
    } else {
      for (int k = 0; k < 4 && s + k < kW; ++k)
        stage_word(d + k, row, c + kPer * k, W, async);
    }
  }
}

// Gradients of the 2 x 8 image pixels of one pooled row's four pixels
// (image pixel (a, x): phase a, pooled pixel x / 2, phase q = x & 1), in
// the reference's signs: gx = left minus right of the vertical [1,2,1],
// gy = above minus below of the horizontal one.  uint8 planes: integers
// from the staged words.
template <class T>
__device__ __forceinline__ void grad_row(const uint32_t* __restrict__ sP,
                                         int il, int tx, int (&gx)[2][8],
                                         int (&gy)[2][8]) {
  // image rows 2i-1 .. 2i+2, columns 2j0-1 .. 2j0+8: row r holds columns
  // 2(j0+u)-1 in bytes 3+u of its phase-1 words and 2(j0+u) in bytes u of
  // its phase-0 words
  uint64_t w1[4], w0[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // r = 0: phase a = 1, row il-1; r = 1: a = 0, row il; r = 2: a = 1,
    // row il; r = 3: a = 0, row il+1 (staged row: local + 2)
    const int a = (r + 1) & 1;
    const int srow = r == 0 ? il + 1 : (r == 3 ? il + 3 : il + 2);
    const uint32_t* q0 = sP + ((a * 2) * T::kPlaneRows + srow) * kWords;
    const uint32_t* q1 = sP + ((a * 2 + 1) * T::kPlaneRows + srow) * kWords;
    w0[r] = q0[tx + 1] | (static_cast<uint64_t>(q0[tx + 2]) << 32);
    w1[r] = q1[tx] | (static_cast<uint64_t>(q1[tx + 1]) << 32);
  }
#define WB_PX(r, c) ((c) & 1 ? byte_of(w0[r], (c) >> 1) \
                             : byte_of(w1[r], 3 + ((c) >> 1)))
#pragma unroll
  for (int y = 1; y <= 2; ++y) {
    int sv[10];
#pragma unroll
    for (int c = 0; c < 10; ++c)
      sv[c] = WB_PX(y - 1, c) + 2 * WB_PX(y, c) + WB_PX(y + 1, c);
#pragma unroll
    for (int x = 1; x <= 8; ++x) {
      gx[y - 1][x - 1] = sv[x - 1] - sv[x + 1];
      gy[y - 1][x - 1] =
          (WB_PX(y - 1, x - 1) + 2 * WB_PX(y - 1, x) + WB_PX(y - 1, x + 1)) -
          (WB_PX(y + 1, x - 1) + 2 * WB_PX(y + 1, x) + WB_PX(y + 1, x + 1));
    }
  }
#undef WB_PX
}

// Staged plane byte of local image pixel (Y, X) of the tile (image rows
// from 2*I0, columns from 2*J0) as float.
template <class T>
__device__ __forceinline__ float staged_px(const uint32_t* __restrict__ sP,
                                           int Y, int X) {
  const uint8_t* P = reinterpret_cast<const uint8_t*>(sP);
  const int pl = (Y & 1) * 2 + (X & 1);
  return __uint2float_rn(
      P[(pl * T::kPlaneRows + (Y >> 1) + 2) * kRowElems + (X >> 1) + 4]);
}

// The pooled bins of one pixel at local (il, jl), jl = -1 or kTW, from the
// staged planes (the smooth's ring columns), 0 off the canvas, into ring
// (k, il + 1, jl == kTW).
template <class T>
__device__ void ring_cell(const uint32_t* sP, float* ring, int il, int jl,
                          bool inside, const Proj& pj) {
  int p[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int Y = 2 * il - 1 + r, X = 2 * jl - 1 + c;  // local image px
      const float v = staged_px<T>(sP, Y, X);
      p[r][c] = static_cast<int>(v);
    }
  int gx[4], gy[4];  // phase a * 2 + q: image pixel (1 + a, 1 + q) of p
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const int y = 1 + (ph >> 1), x = 1 + (ph & 1);
    gx[ph] = tap3(p[y - 1][x - 1], p[y][x - 1], p[y + 1][x - 1]) -
             tap3(p[y - 1][x + 1], p[y][x + 1], p[y + 1][x + 1]);
    gy[ph] = tap3(p[y - 1][x - 1], p[y - 1][x], p[y - 1][x + 1]) -
             tap3(p[y + 1][x - 1], p[y + 1][x], p[y + 1][x + 1]);
  }
  float v[kBins];
  pool(gx, gy, pj, v);
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    ring[(k * T::kPoolRows + il + 1) * 2 + (jl == kTW)] = inside ? v[k] : 0.0f;
}

// Four channel values of one output row at out + f (columns j0..j0+3 of a
// row W wide): one 16-byte store where aligned and inside the row.
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

template <bool kSmooth>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
grad_hist_kernel(const void* __restrict__ planes,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int batch, int H, int W, Proj pj) {
  using T = Tile<kSmooth>;
  extern __shared__ __align__(16) uint32_t smem[];
  float* sPo = reinterpret_cast<float*>(smem);
  float* sRing = sPo + T::kPooled;
  uint32_t* sPbuf = smem + T::kPooled + T::kRing;  // two buffers
  uint32_t* sI = sPbuf + 2 * T::kPlanes;

  const int I0 = blockIdx.y * T::kTH, J0 = blockIdx.x * kTW;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = J0 + 4 * tx;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* pbytes = static_cast<const uint8_t*>(planes);

  const bool async = W % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(planes) & 3u) == 0;
  if (kSmooth) stage<1, T::kTH>(sI, mask, H, W, I0, J0 - 4, false);
  // the planes of the next image are staged while this one is computed
  stage<4, T::kPlaneRows>(sPbuf, pbytes + blockIdx.z * 4 * plane, H, W,
                          I0 - 2, J0 - 4, async);
  cp_async_commit();

  int buf = 0;
  for (int b = blockIdx.z; b < batch; b += gridDim.z, buf ^= 1) {
    __syncthreads();  // the previous image is done with sPo, other buffer
    if (b + gridDim.z < batch)
      stage<4, T::kPlaneRows>(
          sPbuf + (buf ^ 1) * T::kPlanes,
          pbytes + static_cast<size_t>(b + gridDim.z) * 4 * plane, H, W,
          I0 - 2, J0 - 4, async);
    cp_async_commit();
    cp_async_wait_prev();  // this image's words are in
    __syncthreads();
    const uint32_t* sP = sPbuf + buf * T::kPlanes;
    auto* dst = out + static_cast<size_t>(b) * kBins * plane;

    // rows 0 .. kTH-1, and with the smooth the pooled ring rows -1, kTH
#pragma unroll 1
    for (int rr = 0; rr < 2; ++rr) {
      const int il = kSmooth ? 2 * ty + rr - 1 : ty + rr * kBY;
      const int i = I0 + il;
      int gx[2][8], gy[2][8];
      grad_row<T>(sP, il, tx, gx, gy);
      float v[kBins][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int px[4] = {gx[0][2 * g], gx[0][2 * g + 1], gx[1][2 * g],
                         gx[1][2 * g + 1]};
        const int py[4] = {gy[0][2 * g], gy[0][2 * g + 1], gy[1][2 * g],
                         gy[1][2 * g + 1]};
        float pv[kBins];
        pool(px, py, pj, pv);
#pragma unroll
        for (int k = 0; k < kBins; ++k) v[k][g] = pv[k];
      }
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
    if (!kSmooth) continue;

    // the pooled ring columns -1 and kTW (rows -1 .. kTH), then the smooth
    const int tid = ty * kBX + tx;
    if (tid < 2 * T::kPoolRows) {
      const int il = (tid >> 1) - 1, jl = (tid & 1) ? kTW : -1;
      const int i = I0 + il, j = J0 + jl;
      ring_cell<T>(sP, sRing, il, jl,
                               i >= 0 && i < H && j >= 0 && j < W, pj);
    }
    __syncthreads();
#pragma unroll 1
    for (int il = ty; il < T::kTH; il += kBY) {
      const int i = I0 + il;
      if (i >= H) continue;  // warp-uniform: a warp is one row
      const uint32_t in = sI[il * kWords + tx + 1];
#pragma unroll
      for (int k = 0; k < kBins; ++k) {
        // pooled rows il-1 .. il+1, columns -1 .. 4 of this thread
        float p[3][6];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int pr = k * T::kPoolRows + il + r;
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
        float v[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = p[0][g];
          s = __fmaf_rn(2.0f, p[0][g + 1], s);
          s = __fadd_rn(s, p[0][g + 2]);
          s = __fmaf_rn(2.0f, p[1][g], s);
          s = __fmaf_rn(4.0f, p[1][g + 1], s);
          s = __fmaf_rn(2.0f, p[1][g + 2], s);
          s = __fadd_rn(s, p[2][g]);
          s = __fmaf_rn(2.0f, p[2][g + 1], s);
          s = __fadd_rn(s, p[2][g + 2]);
          v[g] = ((in >> (8 * g)) & 255u) ? __fmul_rn(s, 0.0625f) : 0.0f;
        }
        store4(dst, static_cast<size_t>(k) * plane +
                        static_cast<size_t>(i) * W + j0, j0, W, v);
      }
    }
  }
}

// SMs of the current device, queried once per device.
int sm_count() {
  static std::mutex mu;
  static std::map<int, int> sms;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = sms.find(dev);
  if (it != sms.end()) return it->second;
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] = n > 0 ? n : 1;
}

// Dynamic shared memory above 48 KB is an opt-in per kernel and device:
// made once for each (current device, kernel instance).
int opt_in_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int dev = 0;
  cudaGetDevice(&dev);
  const std::lock_guard<std::mutex> lock(mu);
  if (done.count({dev, kernel})) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done.insert({dev, kernel});
  return 0;
}

template <bool kSmooth>
int launch(const void* planes, const uint8_t* mask, void* out, int batch,
           int H, int W, const Proj& pj, cudaStream_t stream) {
  using T = Tile<kSmooth>;
  const auto kernel = grad_hist_kernel<kSmooth>;
  const int opt = opt_in_smem(reinterpret_cast<const void*>(kernel),
                              static_cast<int>(T::kBytes));
  if (opt) return opt;
  const int bx = (W + kTW - 1) / kTW, by = (H + T::kTH - 1) / T::kTH;
  // enough blocks to fill the card; each loops over batch / groups images
  const int target = sm_count() * kBlocksPerSm;
  const int groups = (target + bx * by - 1) / (bx * by);
  dim3 grid(bx, by, groups < batch ? groups : batch);
  dim3 block(kBX, kBY);
  kernel<<<grid, block, T::kBytes, stream>>>(
      planes, mask, static_cast<float*>(out), batch, H, W, pj);
  return 0;
}

Proj projections(const double* cos4, const double* sin4) {
  Proj pj;
  for (int k = 0; k < kBins; ++k) {
    pj.c[k] = cos4[k];
    pj.s[k] = sin4[k];
  }
  return pj;
}

}  // namespace

// B2.  planes (B, 2, 2, H, W) uint8, out (B, 4, H, W) float32; cos4 /
// sin4: the four bins' cos and sin.
extern "C" int wb_grad_hist(const void* planes, const void* mask, void* out,
                            int batch, int H, int W, int smooth,
                            const double* cos4, const double* sin4,
                            void* stream) {
  if (batch > 0 && H > 0 && W > 0) {
    const Proj pj = projections(cos4, sin4);
    const auto* m = static_cast<const uint8_t*>(mask);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int e = smooth ? launch<true>(planes, m, out, batch, H, W, pj, st)
                         : launch<false>(planes, m, out, batch, H, W, pj, st);
    if (e) return e;
  }
  return static_cast<int>(cudaGetLastError());
}
