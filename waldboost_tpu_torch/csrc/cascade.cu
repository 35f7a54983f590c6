// WaldBoost cascades with SPRT rejection over every window origin of the
// channel canvas.  One per-window walk serves three kernels, each with its
// own C entry point:
//
//  wb_cascade          (B3) masked score map, survivor count and n_weak.
//    Replaces: waldboost_tpu/ops/cascade_static.py::
//    cascade_masked_grid_static (_make_static_kernel(masked_out=True)).
//  wb_cascade_response (B4) unmasked hs, alive and n_weak of a frozen
//    cascade over its first T stages (T = n_stages_cap).
//    Replaces: waldboost_tpu/ops/cascade_static.py::
//    cascade_response_grid_static (_make_static_kernel, unmasked kernel).
//  wb_cascade_generic  (B6) the same over the runtime tables of
//    cascade_from_stages: complete-heap or general trees, stages padded to
//    a bucket; n_weak counts only stages whose `active` flag is set.
//    Replaces: waldboost_tpu/ops/cascade_pallas.py::
//    cascade_response_grid_pallas (_make_kernel).
//
// The TPU kernels exit per tile: B3/B4 every 8 stages with the cascade
// baked into the program, B6 per stage through SMEM switch chains.  Here
// the node tables are device arrays and each window exits on its own,
// which is exact because rejection is monotone: a window rejected at stage
// t keeps the hs it had after stage t (the TPU kernels add alive*resp = 0
// from then on), and n_weak counts the stages a window entered alive.
//
// Bound on the H100: canvas reads.  A window costs up to two dependent
// 4-byte loads per stage it enters (depth-2 trees) from an L2-resident
// canvas (VGA: 1112 x 512 x 4 channels x 4 bytes = 9.1 MB per image); the
// least traffic is one read of the canvas and one write of the outputs,
// and the work per window varies with its exit stage, so warps diverge.
//
// Design: one thread per window origin, consecutive threads on consecutive
// columns so a warp's canvas loads for one node coalesce.  Node tables are
// read through the read-only cache (every thread of a warp reads the same
// entry: a broadcast).  hs sums leaf values in f32 in stage order from 0
// (__fadd_rn; the library is built with -fmad=false).  A stage rejects
// when !(hs >= theta): B3 and B4 get -inf for a non-finite theta from the
// host, B6 gets theta as the tables hold it (padding: -inf).  Per-image
// counts: a warp shuffle reduce and one atomicAdd per warp into zeroed
// int32 outputs.  Child indices lie above their parent (checked on the
// host), so every tree walk ends within NN steps.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

struct Tables {
  const int* fr;
  const int* fc;
  const int* fch;
  const float* thr;
  const int* left;
  const int* right;
  const float* pred;
  const float* theta;
  const uint8_t* active;  // nullptr: every stage counts toward n_weak
  int T;
  int NN;
};

// Walks one alive window through stages [0, T); returns its hs and clears
// `alive` at the rejecting stage.
__device__ __forceinline__ float walk(const float* __restrict__ cv, int H,
                                      int W, int r, int c, const Tables& tb,
                                      int& alive, int& nw) {
  float hs = 0.0f;
  for (int t = 0; t < tb.T; ++t) {
    if (tb.active == nullptr || tb.active[t]) ++nw;
    const int base = t * tb.NN;
    int node = 0;
    while (__ldg(tb.left + base + node) >= 0) {
      const int k = base + node;
      const float v = cv[(static_cast<size_t>(__ldg(tb.fch + k)) * H + r +
                          __ldg(tb.fr + k)) * W + c + __ldg(tb.fc + k)];
      node = v <= __ldg(tb.thr + k) ? __ldg(tb.left + k) : __ldg(tb.right + k);
    }
    hs = __fadd_rn(hs, __ldg(tb.pred + base + node));
    if (!(hs >= __ldg(tb.theta + t))) {
      alive = 0;
      break;
    }
  }
  return hs;
}

// kMasked: out0 = masked map (hs where alive, -inf elsewhere), count per
// image.  Otherwise out0 = hs, alive_out = alive (0/1 bytes).
template <bool kMasked>
__global__ void __launch_bounds__(kBlock)
cascade_kernel(const float* __restrict__ canvas, int C, int H, int W,
               const uint8_t* __restrict__ valid, int gu, int gv, Tables tb,
               float* __restrict__ out0, uint8_t* __restrict__ alive_out,
               int* __restrict__ count, int* __restrict__ n_weak) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kBlock + threadIdx.x;
  int alive = 0, nw = 0;
  if (idx < gu * gv) {
    const int r = idx / gv, c = idx % gv;
    float hs = 0.0f;
    alive = valid[idx] != 0;
    if (alive)
      hs = walk(canvas + static_cast<size_t>(b) * C * H * W, H, W, r, c, tb,
                alive, nw);
    const size_t o = static_cast<size_t>(b) * gu * gv + idx;
    if (kMasked) {
      out0[o] = alive ? hs : -INFINITY;
    } else {
      out0[o] = hs;
      alive_out[o] = static_cast<uint8_t>(alive);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    if (kMasked) alive += __shfl_down_sync(0xffffffffu, alive, off);
    nw += __shfl_down_sync(0xffffffffu, nw, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (kMasked && alive) atomicAdd(count + b, alive);
    if (nw) atomicAdd(n_weak + b, nw);
  }
}

template <bool kMasked>
int launch(const void* canvas, int batch, int C, int H, int W,
           const void* valid, int gu, int gv, const Tables& tb, void* out0,
           void* alive_out, void* count, void* n_weak, void* stream) {
  if (batch > 0 && gu > 0 && gv > 0) {
    dim3 grid((gu * gv + kBlock - 1) / kBlock, batch);
    cascade_kernel<kMasked>
        <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(canvas), C, H, W,
            static_cast<const uint8_t*>(valid), gu, gv, tb,
            static_cast<float*>(out0), static_cast<uint8_t*>(alive_out),
            static_cast<int*>(count), static_cast<int*>(n_weak));
  }
  return static_cast<int>(cudaGetLastError());
}

Tables tables(const void* fr, const void* fc, const void* fch,
              const void* thr, const void* left, const void* right,
              const void* pred, const void* theta, const void* active, int T,
              int NN) {
  return Tables{static_cast<const int*>(fr),     static_cast<const int*>(fc),
                static_cast<const int*>(fch),    static_cast<const float*>(thr),
                static_cast<const int*>(left),   static_cast<const int*>(right),
                static_cast<const float*>(pred),
                static_cast<const float*>(theta),
                static_cast<const uint8_t*>(active), T, NN};
}

}  // namespace

// B3: masked map, survivor count and n_weak (count, n_weak zeroed by the
// caller).
extern "C" int wb_cascade(const void* canvas, int batch, int C, int H, int W,
                          const void* valid, int gu, int gv, const void* fr,
                          const void* fc, const void* fch, const void* thr,
                          const void* left, const void* right,
                          const void* pred, const void* theta, int T, int NN,
                          void* masked, void* count, void* n_weak,
                          void* stream) {
  return launch<true>(canvas, batch, C, H, W, valid, gu, gv,
                      tables(fr, fc, fch, thr, left, right, pred, theta,
                             nullptr, T, NN),
                      masked, nullptr, count, n_weak, stream);
}

// B4: hs, alive and n_weak over the first T stages (n_weak zeroed by the
// caller).
extern "C" int wb_cascade_response(const void* canvas, int batch, int C,
                                   int H, int W, const void* valid, int gu,
                                   int gv, const void* fr, const void* fc,
                                   const void* fch, const void* thr,
                                   const void* left, const void* right,
                                   const void* pred, const void* theta, int T,
                                   int NN, void* hs, void* alive,
                                   void* n_weak, void* stream) {
  return launch<false>(canvas, batch, C, H, W, valid, gu, gv,
                       tables(fr, fc, fch, thr, left, right, pred, theta,
                              nullptr, T, NN),
                       hs, alive, nullptr, n_weak, stream);
}

// B6: as B4 over runtime tables with per-stage `active` flags (bool bytes).
extern "C" int wb_cascade_generic(const void* canvas, int batch, int C,
                                  int H, int W, const void* valid, int gu,
                                  int gv, const void* fr, const void* fc,
                                  const void* fch, const void* thr,
                                  const void* left, const void* right,
                                  const void* pred, const void* theta,
                                  const void* active, int T, int NN, void* hs,
                                  void* alive, void* n_weak, void* stream) {
  return launch<false>(canvas, batch, C, H, W, valid, gu, gv,
                       tables(fr, fc, fch, thr, left, right, pred, theta,
                              active, T, NN),
                       hs, alive, nullptr, n_weak, stream);
}
