// The previous design of kernel S1 (csrc/cascade.cu's wb_cascade_suffix
// before its stage-parallel walk): one list entry a thread, each walking
// its stages one after another.  Kept as the "previous design" row of chip_smoke.py's
// S1 timing (phase 9b, in turns with the stage-parallel warp walk); the
// package does not build it.  Same C interface, named
// wb_cascade_suffix_previous.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLayoutHeap2 = 1;  // ops/cascade.py HEAP2 (else GENERAL)

// A canvas value as f32: float32 as it is, bfloat16 widened exactly.
__device__ __forceinline__ float load(const float* __restrict__ w, int off) {
  return __ldg(w + off);
}
__device__ __forceinline__ float load(const __nv_bfloat16* __restrict__ w,
                                      int off) {
  return __uint_as_float(
      static_cast<uint32_t>(
          __ldg(reinterpret_cast<const unsigned short*>(w) + off))
      << 16);
}

template <class E>
__device__ __forceinline__ float value(const E* __restrict__ w,
                                       const int4& n) {
  return n.z >= 0 ? load(w, n.x) : 0.0f;
}

// The leaf value of one stage tree for the window at w, from its root n
// and the root's canvas value v: a node's children and their canvas values
// are loaded together, before the node's compare picks one.
template <class E>
__device__ __forceinline__ float walk(const int4* rec,
                                      const E* __restrict__ w, int4 n,
                                      float v) {
  while (n.z >= 0) {
    const int4 a = rec[n.z & 0xffff], b = rec[n.z >> 16];
    const float va = value(w, a), vb = value(w, b);
    const bool go_left = v <= __int_as_float(n.y);
    const int4 c = go_left ? a : b;
    if (c.z < 0) return __int_as_float(c.w);
    const float vc = go_left ? va : vb;
    n = rec[vc <= __int_as_float(c.y) ? (c.z & 0xffff) : (c.z >> 16)];
    v = value(w, n);
  }
  return __int_as_float(n.w);
}

// A stage of the HEAP2 layout: a = {off0, thr0, off1, thr1}, q = {off2,
// thr2, theta, counts}, p = the leaves 3..6; v0..v2 the canvas values of
// nodes 0..2, loaded together.
struct Heap2 {
  int4 a, q;
  float4 p;
  float v0, v1, v2;
};

template <class E>
__device__ __forceinline__ Heap2 fetch(const int4* s, int t,
                                       const E* __restrict__ w) {
  Heap2 h;
  h.a = s[3 * t];
  h.q = s[3 * t + 1];
  const int4 p = s[3 * t + 2];
  h.p = make_float4(__int_as_float(p.x), __int_as_float(p.y),
                    __int_as_float(p.z), __int_as_float(p.w));
  h.v0 = load(w, h.a.x);
  h.v1 = load(w, h.a.z);
  h.v2 = load(w, h.q.x);
  return h;
}

__device__ __forceinline__ float leaf(const Heap2& h) {
  return h.v0 <= __int_as_float(h.a.y)
             ? (h.v1 <= __int_as_float(h.a.w) ? h.p.x : h.p.y)
             : (h.v2 <= __int_as_float(h.q.y) ? h.p.z : h.p.w);
}

// S1: one list entry a thread, the blocks of one image along x and the
// images along y, so a warp's entries belong to one image.  An alive
// entry walks stages [start, T) from its prefix score with the walk
// above (the tables read through the L1 cache: every thread reads the
// same record), until it is rejected; a dead entry keeps its score.
// Each warp sums its n_weak with shuffles into one atomicAdd.  Bound:
// each entry's chain of dependent loads (record, canvas value, compare)
// over the stages it enters, not bytes.
struct SuffixArgs {
  const void* canvas;  // (B, C, H, W) float32 or bfloat16
  int C, H, W, gv;     // gv: the width of the grid idx indexes
  const long long* idx;  // (B, S) origins r * gv + c
  const float* h_in;     // (B, S) prefix scores
  const uint8_t* alive_in;
  int S;
  const int* table;  // node records (ops/cascade.py::node_records)
  int T, start, NN;
  float* h_out;
  uint8_t* alive_out;
  int* n_weak;  // (B,), zeroed by the caller
};

constexpr int kSuffixBlock = 256;

template <bool kHeap2, class E>
__global__ void __launch_bounds__(kSuffixBlock) suffix_kernel(SuffixArgs a) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kSuffixBlock + threadIdx.x;
  int my_nw = 0;
  if (j < a.S) {
    const size_t i = static_cast<size_t>(b) * a.S + j;
    float hs = a.h_in[i];
    bool alive = a.alive_in[i] != 0;
    if (alive) {
      const long long o = a.idx[i];
      const long long r = o / a.gv, c = o - r * a.gv;
      const E* w = static_cast<const E*>(a.canvas) +
                   static_cast<size_t>(b) * a.C * a.H * a.W + r * a.W + c;
      if (kHeap2) {
        const int4* s = reinterpret_cast<const int4*>(a.table);
        for (int t = a.start; t < a.T; ++t) {
          const Heap2 h = fetch(s, t, w);
          my_nw += h.q.w;
          hs = __fadd_rn(hs, leaf(h));
          if (!(hs >= __int_as_float(h.q.z))) {
            alive = false;
            break;
          }
        }
      } else {
        const int2* stage = reinterpret_cast<const int2*>(a.table);
        const int4* recs =
            reinterpret_cast<const int4*>(a.table + 2 * ((a.T + 1) & ~1));
        for (int t = a.start; t < a.T; ++t) {
          const int4 n = recs[t * a.NN];
          const int2 st = stage[t];
          my_nw += st.y;
          hs = __fadd_rn(hs, walk(recs + t * a.NN, w, n, value(w, n)));
          if (!(hs >= __int_as_float(st.x))) {
            alive = false;
            break;
          }
        }
      }
    }
    a.h_out[i] = hs;
    a.alive_out[i] = static_cast<uint8_t>(alive);
  }
  for (int off = 16; off > 0; off >>= 1)
    my_nw += __shfl_down_sync(0xffffffffu, my_nw, off);
  if ((threadIdx.x & 31) == 0 && my_nw) atomicAdd(a.n_weak + b, my_nw);
}

template <bool kHeap2, class E>
void launch_suffix(const SuffixArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.S + kSuffixBlock - 1) / kSuffixBlock, batch);
  suffix_kernel<kHeap2, E><<<grid, kSuffixBlock, 0, stream>>>(a);
}

}  // namespace

// S1: stages [start, T) of the (B, S) list entries over a float32
// (canvas_bytes 4) or bfloat16 (2) canvas: h_out, alive_out and n_weak
// (zeroed by the caller).
extern "C" int wb_cascade_suffix_previous(const void* canvas, int canvas_bytes,
                                 int batch, int C, int H, int W, int gv,
                                 const void* idx, const void* h_in,
                                 const void* alive_in, int S,
                                 const void* table, int layout, int T,
                                 int start, int NN, void* h_out,
                                 void* alive_out, void* n_weak,
                                 void* stream) {
  if (batch >= 65536 || gv <= 0 || start < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SuffixArgs a{canvas, C, H, W, gv,
                     static_cast<const long long*>(idx),
                     static_cast<const float*>(h_in),
                     static_cast<const uint8_t*>(alive_in), S,
                     static_cast<const int*>(table), T, start, NN,
                     static_cast<float*>(h_out),
                     static_cast<uint8_t*>(alive_out),
                     static_cast<int*>(n_weak)};
  if (batch > 0 && S > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool heap2 = layout == kLayoutHeap2;
    if (canvas_bytes == 4) {
      heap2 ? launch_suffix<true, float>(a, batch, st)
            : launch_suffix<false, float>(a, batch, st);
    } else if (canvas_bytes == 2) {
      heap2 ? launch_suffix<true, __nv_bfloat16>(a, batch, st)
            : launch_suffix<false, __nv_bfloat16>(a, batch, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

