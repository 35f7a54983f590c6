// The first design of kernel B2 (csrc/grad_hist.cu): 32 x 32 tiles staged
// as int, one pooled pixel per thread.  Kept as the "first design" row of
// scripts/sweep_torch_kernels.py; the package does not build it.
//
// grad_hist channel canvas from the polyphase planes: gradients, exact
// oriented projections, 2x2 average pool, 3x3/16 smooth, interior mask.
//
// Replaces: waldboost_tpu/ops/channels_pallas.py::grad_hist_poly_pallas
// (body _make_kernel, tile fetch _db_fetch), the exact uint8 variant.  On
// the TPU the f64-rounded projection f32(f64(gx*cos - gy*sin)) is emulated
// by a verified f32 term plan; the H100 computes it in native f64.
//
// Bound on the H100: the f64 projections (16 per pooled pixel: 4 bins x 4
// phases, two multiplies and a subtract each) and the shared-memory
// stencil reads; the planes are read once (4 uint8 per pixel) and the f32
// canvas written once (16 bytes per pixel).
//
// Design: one 256-thread block per 32x32 output tile.  The tile's planes
// plus a 2-pixel halo are staged in shared memory as int (reads outside
// the canvas give 0, the zero fill of the JAX chain's _shift); gradients
// are exact integers; the pooled channels of the tile plus a 1-pixel ring
// go to shared memory for the smooth, with ring cells outside the canvas
// stored as 0 (the smooth's _shift zero fill), so the result holds for
// any mask, the canvas border included.  Every float and double operation
// is an explicitly rounded intrinsic (and the library is built with
// -fmad=false), in the association order of the reference:
//   pool   = (((TL + BL) + TR) + BR) * 0.25
//   smooth = 9 terms left to right, times 1/16, then mask ? v : 0

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;                 // output tile side (channel px)
constexpr int kHalo = 2;               // staged plane halo
constexpr int kS = kT + 2 * kHalo;     // staged side
constexpr int kP = kT + 2;             // pooled side (tile + 1-px ring)
constexpr int kBins = 4;

struct Proj {
  double c[kBins];
  double s[kBins];
};

__device__ __forceinline__ float project(int gx, int gy, double c, double s) {
  const double v = __dsub_rn(__dmul_rn(static_cast<double>(gx), c),
                             __dmul_rn(static_cast<double>(gy), s));
  return fabsf(__double2float_rn(v));
}

__global__ void __launch_bounds__(256)
grad_hist_kernel(const uint8_t* __restrict__ planes,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int H, int W, int smooth, Proj pj) {
  __shared__ int tile[4][kS][kS];
  __shared__ float pooled[kBins][kP][kP];

  const int b = blockIdx.z;
  const int I0 = blockIdx.y * kT, J0 = blockIdx.x * kT;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* src = planes + static_cast<size_t>(b) * 4 * plane;

  for (int idx = tid; idx < 4 * kS * kS; idx += nthr) {
    const int ph = idx / (kS * kS);
    const int rem = idx % (kS * kS);
    const int y = rem / kS, x = rem % kS;
    const int gi = I0 - kHalo + y, gj = J0 - kHalo + x;
    tile[ph][y][x] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                         ? src[ph * plane + static_cast<size_t>(gi) * W + gj]
                         : 0;
  }
  __syncthreads();

#define PX(a, q, yy, xx) tile[(a) * 2 + (q)][yy][xx]
  // [1,2,1] prefilters of the JAX chain (channels._gradients_poly)
#define SX0(a, yy, xx) (PX(a, 1, yy, (xx) - 1) + 2 * PX(a, 0, yy, xx) + PX(a, 1, yy, xx))
#define SX1(a, yy, xx) (PX(a, 0, yy, xx) + 2 * PX(a, 1, yy, xx) + PX(a, 0, yy, (xx) + 1))
#define SY0(q, yy, xx) (PX(1, q, (yy) - 1, xx) + 2 * PX(0, q, yy, xx) + PX(1, q, yy, xx))
#define SY1(q, yy, xx) (PX(0, q, yy, xx) + 2 * PX(1, q, yy, xx) + PX(0, q, (yy) + 1, xx))

  // pooled positions: the 1-px ring only when the smooth needs it
  const int lo = smooth ? 0 : 1;
  const int span = smooth ? kP : kT;
  for (int idx = tid; idx < span * span; idx += nthr) {
    const int py = lo + idx / span, px = lo + idx % span;
    const int y = py + 1, x = px + 1;  // staged coordinates
    int gx[2][2], gy[2][2];
    gy[0][0] = SX0(1, y - 1, x) - SX0(1, y, x);
    gy[0][1] = SX1(1, y - 1, x) - SX1(1, y, x);
    gy[1][0] = SX0(0, y, x) - SX0(0, y + 1, x);
    gy[1][1] = SX1(0, y, x) - SX1(0, y + 1, x);
    gx[0][0] = SY0(1, y, x - 1) - SY0(1, y, x);
    gx[0][1] = SY0(0, y, x) - SY0(0, y, x + 1);
    gx[1][0] = SY1(1, y, x - 1) - SY1(1, y, x);
    gx[1][1] = SY1(0, y, x) - SY1(0, y, x + 1);
    const int gi = I0 + py - 1, gj = J0 + px - 1;
    const bool inside = gi >= 0 && gi < H && gj >= 0 && gj < W;
#pragma unroll
    for (int k = 0; k < kBins; ++k) {
      const float tl = project(gx[0][0], gy[0][0], pj.c[k], pj.s[k]);
      const float bl = project(gx[1][0], gy[1][0], pj.c[k], pj.s[k]);
      const float tr = project(gx[0][1], gy[0][1], pj.c[k], pj.s[k]);
      const float br = project(gx[1][1], gy[1][1], pj.c[k], pj.s[k]);
      const float p = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(tl, bl), tr), br),
                                0.25f);
      if (smooth) {
        pooled[k][py][px] = inside ? p : 0.0f;
      } else if (inside) {
        out[((static_cast<size_t>(b) * kBins + k) * H + gi) * W + gj] = p;
      }
    }
  }
#undef SY1
#undef SY0
#undef SX1
#undef SX0
#undef PX
  if (!smooth) return;
  __syncthreads();

  for (int idx = tid; idx < kT * kT; idx += nthr) {
    const int oy = idx / kT, ox = idx % kT;
    const int gi = I0 + oy, gj = J0 + ox;
    if (gi >= H || gj >= W) continue;
    const bool keep = mask[static_cast<size_t>(gi) * W + gj] != 0;
    const int y = oy + 1, x = ox + 1;  // pooled coordinates
#pragma unroll
    for (int k = 0; k < kBins; ++k) {
      float v = 0.0f;
      if (keep) {
        const float (*p)[kP] = pooled[k];
        float s = p[y - 1][x - 1];
        s = __fadd_rn(s, __fmul_rn(2.0f, p[y - 1][x]));
        s = __fadd_rn(s, p[y - 1][x + 1]);
        s = __fadd_rn(s, __fmul_rn(2.0f, p[y][x - 1]));
        s = __fadd_rn(s, __fmul_rn(4.0f, p[y][x]));
        s = __fadd_rn(s, __fmul_rn(2.0f, p[y][x + 1]));
        s = __fadd_rn(s, p[y + 1][x - 1]);
        s = __fadd_rn(s, __fmul_rn(2.0f, p[y + 1][x]));
        s = __fadd_rn(s, p[y + 1][x + 1]);
        v = __fmul_rn(s, 0.0625f);
      }
      out[((static_cast<size_t>(b) * kBins + k) * H + gi) * W + gj] = v;
    }
  }
}

}  // namespace

extern "C" int wb_grad_hist(const void* planes, const void* mask, void* out,
                            int batch, int H, int W, int smooth,
                            const double* cos4, const double* sin4,
                            void* stream) {
  if (batch > 0 && H > 0 && W > 0) {
    Proj pj;
    for (int k = 0; k < kBins; ++k) {
      pj.c[k] = cos4[k];
      pj.s[k] = sin4[k];
    }
    dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, batch);
    dim3 block(32, 8);
    grad_hist_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(planes),
        static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, W,
        smooth, pj);
  }
  return static_cast<int>(cudaGetLastError());
}
