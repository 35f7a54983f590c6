// Exact bilinear pyramid resize into the polyphase plane canvas.
//
// Replaces: waldboost_tpu/ops/plane_pallas.py::shelf_pass2_call (body
// _make_shelf_kernel / _piece_compute) and multi_shelf_pass2_call, driven
// by waldboost_tpu/polyphase_fused.py::_poly_planes_fused.  The TPU kernel
// selects the four bilinear corners with one-hot bf16 matmuls on the MXU and
// emulates the exact floor in f32; this kernel blends octave rows in int32
// and floors with a multiply-high.
//
//   V(c)  = (den_r - fr) * g[r0][c] + fr * g[r1][c]      (per octave column)
//   N     = (den_c - fc) * V(c0) + fc * V(c1)
//   plane = floor(N / (den_r * den_c))
//
// Bound on the H100: bytes.  Every canvas byte is written once (the gap
// bytes between levels as 0, by this launch: no memset) and every octave
// byte is read once from HBM; the octave rows a level reads again stay in
// L2.  What stood between the first design and that bound was instruction
// count (a div/mod chain and ~10 table loads per output byte, byte stores,
// a separate memset), so the design removes instructions:
//
// - A block owns a tile of kTR canvas rows x kTC columns of all four
//   planes (host table `tiles`, in an order that keeps an octave's levels
//   together); the tile's `pieces` are the clipped rectangles of the levels
//   it meets, each one 64-byte record that carries its level's parameters.
//   A warp takes one canvas row of the tile at a time, both row phases:
//   lane l computes columns l, l + 32, l + 64, l + 96 of the four planes
//   from the pieces that cover them (0 elsewhere: the gap), the warp passes
//   the 512 bytes through shared memory, and each lane stores 16
//   consecutive bytes.  No byte has two writers, and no barrier is needed
//   beyond the warp.
// - Per piece the two row taps (r0, fr) and the lane's column taps are
//   read once, up front; the vertical blends V of both row phases over
//   every octave column the piece's outputs read ([cmin, cmin + n), host
//   table) go to the warp's rows of shared memory, loaded as aligned words
//   with a funnel shift; both column phases' outputs, which interleave in
//   the octave, read them.  A level at its octave's own size (den 1 x 1)
//   is a copy: its outputs read the octave bytes.
// - The floor is umulhi(2N, magic) >> shift with a per-level magic number
//   proven exact on the host for every N in [0, 255 * den_r * den_c]
//   (polyphase.py::div_magic; 255 * den < 2^31, so 2N fits 32 bits).  The
//   factor 2 rides in the row weights.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Host tables (waldboost_tpu_torch/polyphase.py TILE_COLS, PIECE_COLS),
// read as int4: a tile is (y0, x0, begin, end); a piece is the 64-byte
// record (ya, yb, xa, xb), (cmin, n, oct_off, ow), (oh, rbase, hq, den_h),
// (den_w, jt, magic, shift).

constexpr int kTR = 16;                 // tile rows (polyphase.py)
constexpr int kTC = 128;                // tile columns (polyphase.py)
constexpr int kWarps = 4;               // sweep_torch_kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kVMax = 4 * kTC + 8;      // polyphase.py v_max

// One plane byte from column taps c (c0 | fc << 16) over the blend row V.
__device__ __forceinline__ uint32_t out_byte(const int* V, int c, int cmin,
                                             int last, int dw, uint32_t magic,
                                             int shift) {
  const int c0 = (c & 0xFFFF) - cmin, fc = c >> 16;
  const uint32_t n =
      static_cast<uint32_t>(dw - fc) * static_cast<uint32_t>(V[c0]) +
      static_cast<uint32_t>(fc) *
          static_cast<uint32_t>(V[min(c0 + 1, last)]);
  return __umulhi(n, magic) >> shift;
}

__global__ void __launch_bounds__(kThreads)
planes_kernel(const uint8_t* __restrict__ octs, long long oct_stride,
              const int* __restrict__ tiles, const int* __restrict__ pieces,
              const int* __restrict__ rtap, const int2* __restrict__ ctap,
              uint8_t* __restrict__ planes, int PH, int PW, int vec) {
  // per warp the blend rows of row phases 0 and 1, and the canvas row of
  // the four planes before it is stored
  __shared__ int sV[kWarps][2][kVMax];
  __shared__ __align__(16) uint8_t sO[kWarps][4 * kTC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4 t = __ldg(reinterpret_cast<const int4*>(tiles) + blockIdx.x);
  const int Y0 = t.x, X0 = t.y, pb = t.z, pe = t.w;
  const uint8_t* img = octs + blockIdx.y * oct_stride;
  const size_t plane = static_cast<size_t>(PH) * PW;
  uint8_t* dst = planes + static_cast<size_t>(blockIdx.y) * 4 * plane;

#pragma unroll 1
  for (int y = Y0 + warp; y < min(Y0 + kTR, PH); y += kWarps) {
    // planes (a, q) = 0..3; byte i holds canvas column X0 + lane + 32 i
    uint32_t w[4] = {0, 0, 0, 0};

#pragma unroll 1
    for (int p = pb; p < pe; ++p) {
      const int4* pc = reinterpret_cast<const int4*>(pieces) + p * 4;
      const int4 r0_ = __ldg(pc);  // ya, yb, xa, xb
      if (y < r0_.x || y >= r0_.y) continue;
      const int4 r1_ = __ldg(pc + 1);  // cmin, n, oct_off, ow
      const int4 r2_ = __ldg(pc + 2);  // oh, rbase, hq, den_h
      const int4 r3_ = __ldg(pc + 3);  // den_w, jt, magic, shift
      const int cmin = r1_.x, n = r1_.y, ow = r1_.w;
      // the column taps of this lane's outputs, fetched before the blend
      int2 c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = X0 + lane + 32 * i;
        c[i] = x >= r0_.z && x < r0_.w ? __ldg(ctap + r3_.y + x)
                                       : make_int2(-1, 0);
      }
      const int rt0 = __ldg(rtap + r2_.y + y);
      const int rt1 = __ldg(rtap + r2_.y + r2_.z + y);
      if (r2_.w == 1 && r3_.x == 1) {
        // a level at its octave's own size (den 1 x 1, so fr = fc = 0):
        // each output is the octave byte at its taps
        const uint8_t* g0 =
            img + r1_.z + static_cast<size_t>(rt0 & 0xFFFF) * ow;
        const uint8_t* g1 =
            img + r1_.z + static_cast<size_t>(rt1 & 0xFFFF) * ow;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c[i].x < 0) continue;
          const int q0 = c[i].x & 0xFFFF, q1 = c[i].y & 0xFFFF;
          w[0] |= static_cast<uint32_t>(__ldg(g0 + q0)) << (8 * i);
          w[1] |= static_cast<uint32_t>(__ldg(g0 + q1)) << (8 * i);
          w[2] |= static_cast<uint32_t>(__ldg(g1 + q0)) << (8 * i);
          w[3] |= static_cast<uint32_t>(__ldg(g1 + q1)) << (8 * i);
        }
        continue;
      }

      __syncwarp();  // the previous piece is done with V
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int rt = a ? rt1 : rt0;
        const int r0 = rt & 0xFFFF, fr = rt >> 16;
        const int r1 = min(r0 + 1, r2_.x - 1);
        const int wr0 = 2 * (r2_.w - fr), wr1 = 2 * fr;
        const uint8_t* g0 = img + r1_.z + static_cast<size_t>(r0) * ow + cmin;
        const uint8_t* g1 = g0 + static_cast<size_t>(r1 - r0) * ow;
        int* V = sV[warp][a];
        // the rows' misalignment is the same for every lane and column
        const int m0 = static_cast<int>(reinterpret_cast<uintptr_t>(g0) & 3u);
        const int m1 = static_cast<int>(reinterpret_cast<uintptr_t>(g1) & 3u);
        const uint32_t* w0 = reinterpret_cast<const uint32_t*>(g0 - m0);
        const uint32_t* w1 = reinterpret_cast<const uint32_t*>(g1 - m1);
        for (int k = 4 * lane; k < n; k += 128) {
          uint32_t b0, b1;
          if (cmin + k + 4 <= ow) {  // words holding in-row bytes only
            b0 = __ldg(w0 + (k >> 2));
            b1 = __ldg(w1 + (k >> 2));
            if (m0)
              b0 = __funnelshift_r(b0, __ldg(w0 + (k >> 2) + 1), 8 * m0);
            if (m1)
              b1 = __funnelshift_r(b1, __ldg(w1 + (k >> 2) + 1), 8 * m1);
          } else {  // the row's last columns: bytes one by one
            b0 = b1 = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (cmin + k + i < ow) {
                b0 |= static_cast<uint32_t>(g0[k + i]) << (8 * i);
                b1 |= static_cast<uint32_t>(g1[k + i]) << (8 * i);
              }
          }
          int* v = V + k;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = wr0 * static_cast<int>((b0 >> (8 * i)) & 255u) +
                   wr1 * static_cast<int>((b1 >> (8 * i)) & 255u);
        }
      }
      __syncwarp();

      const int last = ow - 1 - cmin, dw = r3_.x, shift = r3_.w;
      const uint32_t magic = static_cast<uint32_t>(r3_.z);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c[i].x < 0) continue;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int* V = sV[warp][a];
          w[2 * a] |= out_byte(V, c[i].x, cmin, last, dw, magic, shift)
                      << (8 * i);
          w[2 * a + 1] |= out_byte(V, c[i].y, cmin, last, dw, magic, shift)
                          << (8 * i);
        }
      }
    }

    // through shared memory: each lane stores 16 consecutive bytes
    uint8_t* o = sO[warp];
    __syncwarp();  // the previous row's stores have read o
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[k * kTC + lane + 32 * i] = static_cast<uint8_t>(w[k] >> (8 * i));
    __syncwarp();
    const int k = lane >> 3, x = X0 + 16 * (lane & 7);
    const uint8_t* src = o + k * kTC + 16 * (lane & 7);
    uint8_t* row = dst + (static_cast<size_t>(k) * PH + y) * PW;
    if (vec && x + 16 <= PW) {
      *reinterpret_cast<uint4*>(row + x) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 16 && x + i < PW; ++i) row[x + i] = src[i];
    }
  }
}

}  // namespace

extern "C" int wb_planes(const void* octs, long long oct_stride,
                         const void* tiles, int n_tiles, const void* pieces,
                         const void* rtap, const void* ctap, void* planes,
                         int batch, int PH, int PW, int tile_rows,
                         int tile_cols, void* stream) {
  if (tile_rows != kTR || tile_cols != kTC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 0 && batch > 0) {
    // 16-byte stores where every row starts on 16 bytes
    const int vec = PW % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(planes) & 15u) == 0;
    dim3 grid(n_tiles, batch);  // image-major: one image's tiles together
    planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(octs), oct_stride,
        static_cast<const int*>(tiles), static_cast<const int*>(pieces),
        static_cast<const int*>(rtap), static_cast<const int2*>(ctap),
        static_cast<uint8_t*>(planes), PH, PW, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
