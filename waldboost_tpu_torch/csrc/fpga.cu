// FPGA integer channel canvas from the polyphase planes: Sobel, fixed
// orientation responses, quantization, ring mask, uint8-wrap 2x2 pool and
// the optional 3x3/16 smooth with the interior mask.
//
// Replaces: waldboost_tpu/ops/channels_pallas.py::fpga_poly_pallas (body
// _make_fpga_kernel, tile fetch _db_fetch).  On the TPU every value is an
// integer carried in f32 and the ring mask is fetched with a halo through
// manual double-buffered DMA; here everything is int32 and only the final
// store converts to float, so no rounding or FMA hazard exists.
//
// Bound on the H100: bytes.  Per pooled pixel the planes are read once (4
// uint8 per image), the ring mask once (4 uint8) and the interior mask once
// (1 uint8, smooth only) for the whole batch, and C float32 channels are
// written per image (20 bytes at C = 5).  In practice the integer work
// (Sobel, responses, pool: ~130 operations per pixel at C = 5) is close
// behind, so the design cuts instructions as much as bytes.
//
// Design: a block owns a 128 x 16 tile of channel pixels (14 with the
// smooth) and loops over images of the batch (blockIdx.z, gridDim.z
// apart), so the ring and interior tiles are staged in shared memory once
// for all of them.  Every staged tile is a grid of 32-bit words of 4
// consecutive bytes: each word is one or two aligned 4-byte loads shifted
// into place (__funnelshift_r), so rows of any width and base address load
// with coalesced word reads; words that straddle the canvas edge take
// bytes one by one, and cells off the canvas hold 0 (the zero fill of the
// JAX chain's _shift).  The planes are staged per image with a 2-pixel
// halo.  Each thread then computes 4 adjacent channel pixels of two rows:
// 16 word reads per row, the vertical [1,2,1] of each image column once
// for its neighbours, the Sobel pairs of the 2x4 groups zeroed outside the
// ring mask, and per channel of the composite's response list (a small
// table of codes, so every "+" composite is one launch) a quantization
// without clamp or select (see quant) and the wrap pool; each channel is
// stored as one float4 where the address allows it, else as scalars.
// With smooth == 1 the pooled channels (0..63) go to a uint8 tile with a
// 1-pixel ring in dynamic shared memory sized by C: the ring rows are two
// more rows of the same pass (16 rows for 14), the 32 ring-column cells a
// scalar pass, and the 3x3/16 smooth runs on packed bytes (column sums
// four to a word, row sums two to a word).

#include <cstdint>
#include <map>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kTW = 128;               // output tile width (channel px)
constexpr int kBX = 32, kBY = 8;       // threads: 4 columns x 2 rows each
constexpr int kThreads = kBX * kBY;
constexpr int kWords = kTW / 4 + 2;    // staged row: local cols -4 .. kTW+3
constexpr int kRow = kWords * 4;       // bytes of a staged row
constexpr int kMaxOut = 16;            // most channels of one launch
constexpr int kBlocksPerSm = 6;        // register cap (sweep_torch_kernels)

// The tile of channel pixels of one block.  With the smooth, the pooled
// ring rows above and below are computed as rows of the tile too: 14 + 2
// rows, two per warp, as the 16 rows without it.
template <bool kSmooth>
struct Tile {
  static constexpr int kTH = kSmooth ? 14 : 16;  // output rows
  static constexpr int kPlaneRows = kTH + 4;     // planes I0-2 .. I0+kTH+1
  static constexpr int kRingRows = kTH + 2;      // ring I0-1 .. I0+kTH
  static constexpr int kPoolRows = kTH + 2;      // pooled I0-1 .. I0+kTH
  static constexpr size_t kStaticBytes =
      (4 * kPlaneRows + 4 * kRingRows + (kSmooth ? kTH : 0)) * kWords * 4;
};

// response codes (ops/fpga.py RESPONSES)
enum { kDx = 0, kDiagMinus = 1, kDy = 2, kDiagPlus = 3, kMag = 4 };

struct Codes {
  int code[kMaxOut];
  int n;
};

// min(|response| >> 2, 255) of one pixel.  The planes are uint8, so |dx|,
// |dy| <= 1020: no quantized value exceeds 255 and the clamp never acts;
// |trunc((dx -+ dy) / 2)| >> 2 == |dx -+ dy| >> 3 (C's truncating division
// halves the magnitude with a floor).  A pixel outside the ring mask enters
// with dx = dy = 0 and so quantizes to 0, as the ring select does.
template <int kCode>
__device__ __forceinline__ int quant(int dx, int dy) {
  if (kCode == kDx) return abs(dx) >> 2;
  if (kCode == kDiagMinus) return abs(dx - dy) >> 3;
  if (kCode == kDy) return abs(dy) >> 2;
  if (kCode == kDiagPlus) return abs(dx + dy) >> 3;
  return max(abs(dx), abs(dy)) >> 2;
}

// The uint8-wrap 2x2 pool of one channel pixel from its four phases.
template <int kCode>
__device__ __forceinline__ int pool(int dx0, int dy0, int dx1, int dy1,
                                    int dx2, int dy2, int dx3, int dy3) {
  return (((quant<kCode>(dx0, dy0) + quant<kCode>(dx1, dy1)) +
           (quant<kCode>(dx2, dy2) + quant<kCode>(dx3, dy3))) & 255) >> 2;
}

// pool<code> with the code at runtime: one switch per call.
__device__ __forceinline__ int pool_any(int code, const int (&dx)[4],
                                        const int (&dy)[4]) {
#define WB_POOL(c) pool<c>(dx[0], dy[0], dx[1], dy[1], dx[2], dy[2], dx[3], \
                           dy[3])
  switch (code) {
    case kDx: return WB_POOL(kDx);
    case kDiagMinus: return WB_POOL(kDiagMinus);
    case kDy: return WB_POOL(kDy);
    case kDiagPlus: return WB_POOL(kDiagPlus);
    default: return WB_POOL(kMag);
  }
#undef WB_POOL
}

// The pooled channel of the four groups of one output row from the Sobel
// pairs of its 2 x 8 image pixels.
template <int kCode>
__device__ __forceinline__ void pool_row(const int (&dx)[2][8],
                                         const int (&dy)[2][8], int (&v)[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
    v[g] = pool<kCode>(dx[0][2 * g], dy[0][2 * g], dx[1][2 * g], dy[1][2 * g],
                       dx[0][2 * g + 1], dy[0][2 * g + 1], dx[1][2 * g + 1],
                       dy[1][2 * g + 1]);
}

// An integer 0 <= v < 2^23 as float: two full-rate instructions, exact.
__device__ __forceinline__ float to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f);
}

// Sobel of image pixel (1 + a, 1 + q) of a 4x4 neighbourhood p.
__device__ __forceinline__ void sobel(const int (&p)[4][4], int a, int q,
                                      int& dx, int& dy) {
  const int y = 1 + a, x = 1 + q;
  // vertical [1,2,1] prefilter then right minus left -> dx
  const int sy_r = p[y - 1][x + 1] + 2 * p[y][x + 1] + p[y + 1][x + 1];
  const int sy_l = p[y - 1][x - 1] + 2 * p[y][x - 1] + p[y + 1][x - 1];
  // horizontal [1,2,1] prefilter then below minus above -> dy
  const int sx_b = p[y + 1][x - 1] + 2 * p[y + 1][x] + p[y + 1][x + 1];
  const int sx_a = p[y - 1][x - 1] + 2 * p[y - 1][x] + p[y - 1][x + 1];
  dx = sy_r - sy_l;
  dy = sx_b - sx_a;
}

__device__ __forceinline__ int byte_of(uint64_t v, int k) {
  return static_cast<int>((v >> (8 * k)) & 255u);
}

// Stage rows row0 .. row0+kRows-1 of kPlanes (H, W) uint8 planes (plane
// stride H*W) as words of kWords per row: word s holds columns col0 + 4s ..
// col0 + 4s + 3, bytes off the canvas 0.
template <int kPlanes, int kRows>
__device__ void stage(uint32_t* __restrict__ dst,
                      const uint8_t* __restrict__ src, int H, int W, int row0,
                      int col0) {
  const size_t plane = static_cast<size_t>(H) * W;
  constexpr int n = kPlanes * kRows * kWords;
  for (int idx = threadIdx.y * kBX + threadIdx.x; idx < n; idx += kThreads) {
    const int pr = idx / kWords, s = idx - pr * kWords;
    const int pl = pr / kRows, gi = row0 + (pr - pl * kRows);
    const int c = col0 + 4 * s;
    uint32_t w = 0;
    if (gi >= 0 && gi < H) {
      const uint8_t* row = src + pl * plane + static_cast<size_t>(gi) * W;
      if (c >= 0 && c + 4 <= W) {
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
    dst[idx] = w;
  }
}

// Sobel pairs of the 2 x 8 image pixels of one output row's four groups
// (pixel (a, x): phase a, group x / 2, phase q = x & 1), 0 where the ring
// mask is 0.
template <class T>
__device__ __forceinline__ void sobel_row(const uint32_t* __restrict__ sP,
                                          const uint32_t* __restrict__ sR,
                                          int il, int tx, int (&dx)[2][8],
                                          int (&dy)[2][8]) {
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
  // image rows 1, 2 (phase a = row - 1) and columns 1 .. 8 of the 4 x 10
  // block; the vertical prefilter of each column serves its neighbours
#pragma unroll
  for (int y = 1; y <= 2; ++y) {
    int sv[10];
#pragma unroll
    for (int c = 0; c < 10; ++c)
      sv[c] = WB_PX(y - 1, c) + 2 * WB_PX(y, c) + WB_PX(y + 1, c);
#pragma unroll
    for (int x = 1; x <= 8; ++x) {
      dx[y - 1][x - 1] = sv[x + 1] - sv[x - 1];
      dy[y - 1][x - 1] =
          (WB_PX(y + 1, x - 1) + 2 * WB_PX(y + 1, x) + WB_PX(y + 1, x + 1)) -
          (WB_PX(y - 1, x - 1) + 2 * WB_PX(y - 1, x) + WB_PX(y - 1, x + 1));
    }
  }
#undef WB_PX
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const uint32_t m = sR[(ph * T::kRingRows + il + 1) * kWords + tx + 1];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (!((m >> (8 * g)) & 255u))
        dx[ph >> 1][2 * g + (ph & 1)] = dy[ph >> 1][2 * g + (ph & 1)] = 0;
  }
}

// The pooled channels of one group at local (il, jl), jl = -1 or kTW, from
// the staged bytes (the smooth's ring columns): into po row il + 1, byte
// jl + 4, written as its whole word with the other bytes 0 (the packed
// column sums of smooth4 carry upward from them).
template <class T>
__device__ void ring_cell(const uint8_t* P, const uint8_t* R, uint32_t* po,
                          int il, int jl, const Codes& cd) {
  int p[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int Y = 2 * il - 1 + r, X = 2 * jl - 1 + c;  // local image px
      const int pl = (Y & 1) * 2 + (X & 1);
      p[r][c] = P[(pl * T::kPlaneRows + (Y >> 1) + 2) * kRow + (X >> 1) + 4];
    }
  int dx[4], dy[4];  // phase a * 2 + q
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    sobel(p, ph >> 1, ph & 1, dx[ph], dy[ph]);
    if (!R[(ph * T::kRingRows + il + 1) * kRow + jl + 4]) dx[ph] = dy[ph] = 0;
  }
  const int word = (jl + 4) >> 2, shift = 8 * ((jl + 4) & 3);
  for (int k = 0; k < cd.n; ++k)
    po[(k * T::kPoolRows + il + 1) * kWords + word] =
        static_cast<uint32_t>(pool_any(cd.code[k], dx, dy)) << shift;
}

// Four channel values of one output row at out + f (columns j0..j0+3 of
// a row W wide): one float4 where aligned and inside the row.
__device__ __forceinline__ void store4(float* __restrict__ out, size_t f,
                                       int j0, int W, const int (&v)[4]) {
  if (j0 + 4 <= W && (reinterpret_cast<uintptr_t>(out + f) & 15u) == 0) {
    *reinterpret_cast<float4*>(out + f) = make_float4(
        to_float(v[0]), to_float(v[1]), to_float(v[2]), to_float(v[3]));
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (j0 + g < W) out[f + g] = to_float(v[g]);
  }
}

// The 3x3/16 smooth of the four pooled values at local row il, columns
// j0l .. j0l+3, from the packed bytes of the pooled tile po (rows il-1 ..
// il+1 at staged rows il .. il+2): the column sums top + 2 mid + bottom
// (<= 252) stay packed four to a word, the row sums (<= 1008) two to a
// word, and in is the interior mask word of the four pixels.
__device__ __forceinline__ void smooth4(const uint32_t* __restrict__ po,
                                        int tx, uint32_t in, int (&v)[4]) {
  uint32_t c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    c[j] = po[tx + j] + 2 * po[kWords + tx + j] + po[2 * kWords + tx + j];
  const uint32_t e = __byte_perm(c[1], 0, 0x4240);  // columns 0, 2
  const uint32_t o = __byte_perm(c[1], 0, 0x4341);  // columns 1, 3
  const uint32_t l = __byte_perm(c[0], c[1], 0x0503) & 0x00ff00ffu;  // -1, 1
  const uint32_t r = __byte_perm(c[1], c[2], 0x0402) & 0x00ff00ffu;  // 2, 4
  const uint32_t m02 = __vcmpne2(__byte_perm(in, 0, 0x4240), 0);
  const uint32_t m13 = __vcmpne2(__byte_perm(in, 0, 0x4341), 0);
  const uint32_t s02 = (((l + 2 * e + o) >> 4) & 0x003f003fu) & m02;
  const uint32_t s13 = (((e + 2 * o + r) >> 4) & 0x003f003fu) & m13;
  v[0] = static_cast<int>(s02 & 0xffffu);
  v[1] = static_cast<int>(s13 & 0xffffu);
  v[2] = static_cast<int>(s02 >> 16);
  v[3] = static_cast<int>(s13 >> 16);
}

template <bool kSmooth>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fpga_kernel(const uint8_t* __restrict__ planes,
            const uint8_t* __restrict__ ring,
            const uint8_t* __restrict__ interior, float* __restrict__ out,
            int batch, int H, int W, Codes cd) {
  using T = Tile<kSmooth>;
  __shared__ uint32_t sP[4 * T::kPlaneRows * kWords];
  __shared__ uint32_t sR[4 * T::kRingRows * kWords];
  __shared__ uint32_t sI[kSmooth ? T::kTH * kWords : 1];
  extern __shared__ uint32_t sPo[];  // smooth: C x kPoolRows x kWords

  const int I0 = blockIdx.y * T::kTH, J0 = blockIdx.x * kTW;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = J0 + 4 * tx;
  const size_t plane = static_cast<size_t>(H) * W;

  stage<4, T::kRingRows>(sR, ring, H, W, I0 - 1, J0 - 4);
  if (kSmooth) stage<1, T::kTH>(sI, interior, H, W, I0, J0 - 4);

  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    __syncthreads();  // the previous image is done with sP / sPo
    stage<4, T::kPlaneRows>(sP, planes + static_cast<size_t>(b) * 4 * plane,
                            H, W, I0 - 2, J0 - 4);
    __syncthreads();
    float* dst = out + static_cast<size_t>(b) * cd.n * plane;

    // rows 0 .. kTH-1, and with the smooth the pooled ring rows -1, kTH
#pragma unroll 1
    for (int rr = 0; rr < 2; ++rr) {
      const int il = kSmooth ? 2 * ty + rr - 1 : ty + rr * kBY;
      int dx[2][8], dy[2][8];
      sobel_row<T>(sP, sR, il, tx, dx, dy);
      for (int k = 0; k < cd.n; ++k) {
        int v[4];
        switch (cd.code[k]) {
          case kDx: pool_row<kDx>(dx, dy, v); break;
          case kDiagMinus: pool_row<kDiagMinus>(dx, dy, v); break;
          case kDy: pool_row<kDy>(dx, dy, v); break;
          case kDiagPlus: pool_row<kDiagPlus>(dx, dy, v); break;
          default: pool_row<kMag>(dx, dy, v);
        }
        if (kSmooth) {
          sPo[(k * T::kPoolRows + il + 1) * kWords + tx + 1] =
              static_cast<uint32_t>(v[0]) | (static_cast<uint32_t>(v[1]) << 8)
              | (static_cast<uint32_t>(v[2]) << 16)
              | (static_cast<uint32_t>(v[3]) << 24);
        } else if (I0 + il < H) {
          store4(dst, static_cast<size_t>(k) * plane +
                          static_cast<size_t>(I0 + il) * W + j0, j0, W, v);
        }
      }
    }
    if (!kSmooth) continue;

    // the pooled ring columns -1 and kTW (rows -1 .. kTH), then the smooth
    const int tid = ty * kBX + tx;
    if (tid < 2 * T::kPoolRows)
      ring_cell<T>(reinterpret_cast<const uint8_t*>(sP),
                   reinterpret_cast<const uint8_t*>(sR),
                   sPo, (tid >> 1) - 1,
                   (tid & 1) ? kTW : -1, cd);
    __syncthreads();
#pragma unroll 1
    for (int il = ty; il < T::kTH; il += kBY) {
      const int i = I0 + il;
      if (i >= H) continue;
      const uint32_t in = sI[il * kWords + tx + 1];
      for (int k = 0; k < cd.n; ++k) {
        int v[4];
        smooth4(sPo + (k * T::kPoolRows + il) * kWords, tx, in, v);
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

template <bool kSmooth>
int launch(const uint8_t* planes, const uint8_t* ring,
           const uint8_t* interior, float* out, int batch, int H, int W,
           const Codes& cd, cudaStream_t stream) {
  using T = Tile<kSmooth>;
  const size_t po = kSmooth ? static_cast<size_t>(cd.n) * T::kPoolRows *
                                  kWords * sizeof(uint32_t) : 0;
  if (T::kStaticBytes + po > 48 * 1024) {  // the opt-in above 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        fpga_kernel<kSmooth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(po));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bx = (W + kTW - 1) / kTW, by = (H + T::kTH - 1) / T::kTH;
  // enough blocks to fill the card; each loops over batch / groups images
  const int target = sm_count() * kBlocksPerSm;
  const int groups = (target + bx * by - 1) / (bx * by);
  dim3 grid(bx, by, groups < batch ? groups : batch);
  dim3 block(kBX, kBY);
  fpga_kernel<kSmooth><<<grid, block, po, stream>>>(planes, ring, interior,
                                                    out, batch, H, W, cd);
  return 0;
}

}  // namespace

extern "C" int wb_fpga(const void* planes, const void* ring,
                       const void* interior, void* out, int batch, int H,
                       int W, int smooth, const int* codes, int n_codes,
                       void* stream) {
  if (n_codes < 1 || n_codes > kMaxOut) return static_cast<int>(
      cudaErrorInvalidValue);
  if (batch > 0 && H > 0 && W > 0) {
    Codes cd;
    for (int k = 0; k < kMaxOut; ++k) cd.code[k] = k < n_codes ? codes[k] : 0;
    cd.n = n_codes;
    const auto* p = static_cast<const uint8_t*>(planes);
    const auto* r = static_cast<const uint8_t*>(ring);
    const auto* in = static_cast<const uint8_t*>(interior);
    auto* o = static_cast<float*>(out);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int e = smooth ? launch<true>(p, r, in, o, batch, H, W, cd, st)
                         : launch<false>(p, r, in, o, batch, H, W, cd, st);
    if (e) return e;
  }
  return static_cast<int>(cudaGetLastError());
}
