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
// uint8), the ring mask once (4 uint8), the interior mask once (1 uint8,
// smooth only) and C float32 channels written (20 bytes at C = 5); the
// integer work is some 60 operations per channel and pixel.
//
// Design (correct and simple, not fast): one thread per output channel
// pixel per image, launched as 32x8 blocks over (W, H, B).  A thread reads
// the 4x4 image-canvas neighbourhood of its 2x2 pixel group from the four
// planes (reads outside the canvas give 0, the zero fill of the JAX chain's
// _shift), computes the four Sobel pairs once and then every channel of
// the composite's response list from them.  The kind arrives as a small
// table of response codes, so every "+" composite is one launch of one
// compiled kernel.  With smooth == 1 the block first stores the pooled
// channels of its tile plus a 1-pixel ring in shared memory (ring cells
// outside the canvas hold 0), then each thread smooths its pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;            // output tile width (channel px)
constexpr int kTH = 8;             // output tile height
constexpr int kPW = kTW + 2;       // pooled tile with its 1-px ring
constexpr int kPH = kTH + 2;
constexpr int kMaxOut = 16;        // most channels of one launch

// response codes (ops/fpga.py RESPONSES)
enum { kDx = 0, kDiagMinus = 1, kDy = 2, kDiagPlus = 3, kMag = 4 };

struct Codes {
  int code[kMaxOut];
  int n;
};

// The Sobel pairs and ring-mask bits of the 2x2 image pixels of one
// channel pixel, phase [a][q] = image pixel (2i + a, 2j + q).
struct Group {
  int dx[2][2];
  int dy[2][2];
  bool keep[2][2];
};

__device__ __forceinline__ int pixel(const uint8_t* src, size_t plane, int H,
                                     int W, int y, int x) {
  if (y < 0 || x < 0 || y >= 2 * H || x >= 2 * W) return 0;
  return src[static_cast<size_t>((y & 1) * 2 + (x & 1)) * plane +
             static_cast<size_t>(y >> 1) * W + (x >> 1)];
}

__device__ Group sobel_group(const uint8_t* src, const uint8_t* ring,
                             size_t plane, int H, int W, int i, int j) {
  int p[4][4];  // image rows 2i-1 .. 2i+2, columns 2j-1 .. 2j+2
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      p[r][c] = pixel(src, plane, H, W, 2 * i - 1 + r, 2 * j - 1 + c);
  Group g;
  const size_t at = static_cast<size_t>(i) * W + j;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int y = 1 + a, x = 1 + q;
      // vertical [1,2,1] prefilter then right minus left -> dx
      const int sy_r = p[y - 1][x + 1] + 2 * p[y][x + 1] + p[y + 1][x + 1];
      const int sy_l = p[y - 1][x - 1] + 2 * p[y][x - 1] + p[y + 1][x - 1];
      // horizontal [1,2,1] prefilter then below minus above -> dy
      const int sx_b = p[y + 1][x - 1] + 2 * p[y + 1][x] + p[y + 1][x + 1];
      const int sx_a = p[y - 1][x - 1] + 2 * p[y - 1][x] + p[y - 1][x + 1];
      g.dx[a][q] = sy_r - sy_l;
      g.dy[a][q] = sx_b - sx_a;
      g.keep[a][q] = ring[static_cast<size_t>(a * 2 + q) * plane + at] != 0;
    }
  return g;
}

__device__ __forceinline__ int response(int code, int dx, int dy) {
  switch (code) {
    case kDx: return dx;
    case kDiagMinus: return (dx - dy) / 2;  // C division truncates to zero
    case kDy: return dy;
    case kDiagPlus: return (dx + dy) / 2;
    default: return max(abs(dx), abs(dy));
  }
}

// One channel of the pooled canvas: quantize, ring select, wrap pool.
__device__ __forceinline__ int pooled(const Group& g, int code) {
  int q[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int v = min(abs(response(code, g.dx[a][b], g.dy[a][b])) >> 2, 255);
      q[a][b] = g.keep[a][b] ? v : 0;
    }
  return (((q[0][0] + q[1][0]) + (q[0][1] + q[1][1])) & 255) >> 2;
}

__global__ void __launch_bounds__(kTW * kTH)
fpga_kernel(const uint8_t* __restrict__ planes,
            const uint8_t* __restrict__ ring,
            const uint8_t* __restrict__ interior, float* __restrict__ out,
            int H, int W, int smooth, Codes cd) {
  __shared__ int tile[kMaxOut][kPH][kPW];

  const int b = blockIdx.z;
  const int I0 = blockIdx.y * kTH, J0 = blockIdx.x * kTW;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* src = planes + static_cast<size_t>(b) * 4 * plane;
  float* dst = out + static_cast<size_t>(b) * cd.n * plane;
  const int i = I0 + threadIdx.y, j = J0 + threadIdx.x;

  if (!smooth) {
    if (i >= H || j >= W) return;
    const Group g = sobel_group(src, ring, plane, H, W, i, j);
    const size_t at = static_cast<size_t>(i) * W + j;
    for (int k = 0; k < cd.n; ++k)
      dst[k * plane + at] = static_cast<float>(pooled(g, cd.code[k]));
    return;
  }

  const int tid = threadIdx.y * kTW + threadIdx.x;
  for (int idx = tid; idx < kPH * kPW; idx += kTW * kTH) {
    const int py = idx / kPW, px = idx % kPW;
    const int gi = I0 - 1 + py, gj = J0 - 1 + px;
    if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
      const Group g = sobel_group(src, ring, plane, H, W, gi, gj);
      for (int k = 0; k < cd.n; ++k) tile[k][py][px] = pooled(g, cd.code[k]);
    } else {
      for (int k = 0; k < cd.n; ++k) tile[k][py][px] = 0;
    }
  }
  __syncthreads();
  if (i >= H || j >= W) return;
  const size_t at = static_cast<size_t>(i) * W + j;
  const bool keep = interior[at] != 0;
  const int y = threadIdx.y + 1, x = threadIdx.x + 1;
  for (int k = 0; k < cd.n; ++k) {
    int v = 0;
    if (keep) {
      const int (*p)[kPW] = tile[k];
      const int s = p[y - 1][x - 1] + 2 * p[y - 1][x] + p[y - 1][x + 1] +
                    2 * p[y][x - 1] + 4 * p[y][x] + 2 * p[y][x + 1] +
                    p[y + 1][x - 1] + 2 * p[y + 1][x] + p[y + 1][x + 1];
      v = s >> 4;
    }
    dst[k * plane + at] = static_cast<float>(v);
  }
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
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, batch);
    dim3 block(kTW, kTH);
    fpga_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(planes), static_cast<const uint8_t*>(ring),
        static_cast<const uint8_t*>(interior), static_cast<float*>(out), H, W,
        smooth, cd);
  }
  return static_cast<int>(cudaGetLastError());
}
