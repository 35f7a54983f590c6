// The first design of kernel B1 (csrc/planes.cu): one thread per output
// byte over a canvas its wrapper zeroed first.  Kept as the "first design"
// row of scripts/sweep_torch_kernels.py; the package does not build it.
//
// Exact bilinear pyramid resize into the polyphase plane canvas.
//
// Replaces: waldboost_tpu/ops/plane_pallas.py::shelf_pass2_call (body
// _make_shelf_kernel / _piece_compute), driven by
// waldboost_tpu/polyphase_fused.py::_poly_planes_fused.  The TPU kernel
// selects the four bilinear corners with one-hot bf16 matmuls on the MXU and
// emulates the exact floor in f32; this kernel gathers the corners directly
// and floors an int32 numerator.
//
// Bound on the H100: memory.  Each output byte costs four uint8 corner
// reads that mostly hit L1/L2 (neighbouring outputs share corners) plus a
// few tap-table reads; the arithmetic is ~12 integer ops.  A VGA batch
// writes ~2.3 MB of planes per image.
//
// Design: one thread per element of one level block (2, 2, hq, wq), the
// column index fastest so a warp reads neighbouring corners and writes 32
// neighbouring bytes.  A host table maps every thread block to (level,
// first element), so blocks never straddle levels and no thread idles on a
// small level.  The wrapper zeroes the canvas first; gaps between levels
// stay zero.
//
//   N = (den_c - fc) * ((den_r - fr) * g00 + fr * g10)
//     + fc * ((den_r - fr) * g01 + fr * g11)
//   plane = N / (den_r * den_c)          (N >= 0: integer division floors)
//
// 255 * den_r * den_c < 2^31 is checked on the host for every level.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// columns of the per-level meta table (waldboost_tpu_torch/polyphase.py
// META_COLS)
enum {
  M_OCT_OFF, M_OH, M_OW, M_HQ, M_WQ, M_Y0, M_X0, M_DEN_H, M_DEN_W,
  M_TAP_H, M_TAP_W, M_ELEMS, M_COLS
};

constexpr int kBlock = 256;  // polyphase.py PLANE_BLOCK

__global__ void __launch_bounds__(kBlock)
planes_kernel(const uint8_t* __restrict__ octs, long long oct_stride,
              const int* __restrict__ meta, const int* __restrict__ blocks,
              const int* __restrict__ i0h, const int* __restrict__ frh,
              const int* __restrict__ i0w, const int* __restrict__ frw,
              uint8_t* __restrict__ planes, int PH, int PW) {
  const int lvl = blocks[2 * blockIdx.x];
  const int* m = meta + lvl * M_COLS;
  const int e = blocks[2 * blockIdx.x + 1] + threadIdx.x;
  if (e >= m[M_ELEMS]) return;
  const int hq = m[M_HQ], wq = m[M_WQ];
  const int j = e % wq;
  const int t = e / wq;
  const int i = t % hq;
  const int ph = t / hq;  // a * 2 + q
  const int a = ph >> 1, q = ph & 1;

  const int rt = m[M_TAP_H] + a * hq + i;
  const int ct = m[M_TAP_W] + q * wq + j;
  const int oh = m[M_OH], ow = m[M_OW];
  const int r0 = i0h[rt], fr = frh[rt];
  const int c0 = i0w[ct], fc = frw[ct];
  const int r1 = min(r0 + 1, oh - 1), c1 = min(c0 + 1, ow - 1);

  const uint8_t* img = octs + blockIdx.y * oct_stride + m[M_OCT_OFF];
  const int g00 = img[r0 * ow + c0], g01 = img[r0 * ow + c1];
  const int g10 = img[r1 * ow + c0], g11 = img[r1 * ow + c1];

  const int dr = m[M_DEN_H], dc = m[M_DEN_W];
  const int wr0 = dr - fr;
  const int n = (dc - fc) * (wr0 * g00 + fr * g10) + fc * (wr0 * g01 + fr * g11);
  const int v = n / (dr * dc);

  const size_t out = ((static_cast<size_t>(blockIdx.y) * 4 + ph) * PH
                      + m[M_Y0] + i) * PW + m[M_X0] + j;
  planes[out] = static_cast<uint8_t>(v);
}

}  // namespace

extern "C" int wb_planes(const void* octs, long long oct_stride,
                         const void* meta, const void* blocks, int n_blocks,
                         const void* i0h, const void* frh, const void* i0w,
                         const void* frw, void* planes, int batch, int PH,
                         int PW, void* stream) {
  if (n_blocks > 0 && batch > 0) {
    dim3 grid(n_blocks, batch);
    planes_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(octs), oct_stride,
        static_cast<const int*>(meta), static_cast<const int*>(blocks),
        static_cast<const int*>(i0h), static_cast<const int*>(frh),
        static_cast<const int*>(i0w), static_cast<const int*>(frw),
        static_cast<uint8_t*>(planes), PH, PW);
  }
  return static_cast<int>(cudaGetLastError());
}
