// S3: greedy NMS of a batch of candidate sets in one launch, one block a
// set, with nothing read back by the host.
//
//  wb_nms  per row b of (B, K) candidates (rects (B, K, 4) XYXY float32,
//          scores (B, K) float32, valid (B, K) bool), the keep mask (B, K)
//          of greedy NMS at IoU threshold thr: while a valid candidate
//          remains, the best remaining one is kept, and it and every
//          remaining candidate whose IoU with it exceeds thr are dropped.
//
// Replaces no TPU kernel: the JAX package's nms_device
// (waldboost_tpu/ops/nms.py) is a lax.while_loop, and the port's plain
// version (ops/nms.py::nms_plain) launched about 20 small ops a round and
// read one bool a round on the host: 67 rounds a VGA scene batch, which
// left the card idle for 95% of the call.
//
// Bitwise the plain loop on every input on which that loop ends:
//  - the pick is the loop's torch.argmax over where(remaining, scores,
//    -inf): NaN above every number, then the higher score (-0 == +0),
//    then the lower index.  The pick is taken among remaining candidates
//    only; the loop differs only where every remaining score is -inf and
//    index 0 does not remain, where it never ends.  So a row ends after
//    at most K rounds.
//  - the IoU is the loop's float32 arithmetic in its order, each
//    operation rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn,
//    __fdiv_rn; the library builds with -fmad=false too), with
//    torch.maximum / minimum / clamp's NaN propagation: area =
//    clamp(x2 - x1, 0) * clamp(y2 - y1, 0); inter from the pair's
//    max / min corners alike; union = (area_pick + area_j) - inter; iou =
//    union > 0 ? inter / union : 0; dropped where iou > thr, thr the
//    threshold rounded to float32 as torch compares a float32 tensor with
//    a Python float.
//  - the input need not be sorted (the multi-model path scales scores
//    after the extraction).
//
// Design: a block of min(512, K rounded up to 32) threads a row (the
// fastest of 128, 256, 512 and 1024 on the H100 at the benchmark's
// cells); thread t owns candidates t, t + blockDim,
// ...  Set-up loads the row's corners, areas, rank keys (the score as an
// ordered unsigned) and a state byte a candidate (remaining, kept,
// dropped) into dynamic shared memory, 25 bytes a candidate.  A round:
// each thread holds the best of its remaining candidates; a warp's best
// by two hardware reductions (__reduce_max_sync of the keys, then
// __reduce_min_sync of the indices holding the top key), one shared slot
// a warp (two sets, alternating by round, so one barrier a round
// suffices), then every warp reduces the slots to the same pick; no pick
// ends the row.  Each thread then suppresses its own candidates against
// the pick and finds its best of those that remain for the next round in
// the same pass.  Only the owner touches a candidate's state, and the
// pick's corners are read-only.  Where 25 * K bytes exceed the block's
// shared memory (K above about 9000), the same kernel (kShared false)
// reads corners and scores from global memory, computes areas and keys
// as it goes and keeps the state bytes in the keep output; run at every
// K, that form is 9-18% slower on the H100 at the benchmark's cells
// (0.067 against 0.057 ms a VGA scene batch of 8 x 1024), so the shared
// form stays where it fits.  Finally each thread writes keep for its
// candidates.
//
// Bound on the H100: latency.  The candidates are read once and keep
// written once (22 bytes a candidate: 180 KB a VGA batch of 8 x 1024,
// 0.05 us at 3.35 TB/s); what a row costs is its rounds, each a chain of
// reductions, one barrier and one IoU a remaining candidate.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr uint32_t kNone = 0xffffffffu;  // index of "no candidate"
constexpr uint8_t kDropped = 0, kKept = 1, kRemaining = 2;
constexpr int kSharedBytes = 6 * 4 + 1;  // a candidate in shared memory

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.maximum / torch.minimum: NaN where either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}
// torch.clamp(x, min=0): NaN stays NaN
__device__ __forceinline__ float clamp0(float x) {
  return x != x ? x : fmaxf(x, 0.f);
}

__device__ __forceinline__ float area_of(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(clamp0(__fsub_rn(x2, x1)), clamp0(__fsub_rn(y2, y1)));
}

// A score's rank as an unsigned key, as torch.argmax ranks: ascending
// with the score, -0 as +0, NaN above +inf; 0 (no float's key) is "no
// candidate".
__device__ __forceinline__ uint32_t rank_key(float s) {
  if (s != s) return 0xffffffffu;
  const uint32_t b = __float_as_uint(__fadd_rn(s, 0.f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The block's best (key, index): the highest key, the lowest index among
// equal keys; every thread gets it.  Each warp's by two hardware
// reductions, then the warps' from shared slots (set par of two,
// alternating by round, so one barrier a round suffices).
__device__ __forceinline__ void block_best(uint32_t& key, uint32_t& idx,
                                           uint32_t (*slot_k)[kMaxWarps],
                                           uint32_t (*slot_i)[kMaxWarps],
                                           int par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  uint32_t k = __reduce_max_sync(0xffffffffu, key);
  uint32_t i = __reduce_min_sync(0xffffffffu, key == k ? idx : kNone);
  if (lane == 0) {
    slot_k[par][warp] = k;
    slot_i[par][warp] = i;
  }
  __syncthreads();
  const uint32_t wk = lane < n_warps ? slot_k[par][lane] : 0u;
  const uint32_t wi = lane < n_warps ? slot_i[par][lane] : kNone;
  k = __reduce_max_sync(0xffffffffu, wk);
  idx = __reduce_min_sync(0xffffffffu, wk == k ? wi : kNone);
  key = k;
}

struct Args {
  const float* rects;   // (B, K, 4)
  const float* scores;  // (B, K)
  const uint8_t* valid; // (B, K)
  uint8_t* keep;        // (B, K)
  int K;
  float thr;
};

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) nms_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ uint32_t slot_k[2][kMaxWarps], slot_i[2][kMaxWarps];
  const int K = a.K;
  const long long row = static_cast<long long>(blockIdx.x) * K;
  const float* R = a.rects + row * 4;
  const float* S = a.scores + row;
  const uint8_t* V = a.valid + row;
  uint8_t* keep = a.keep + row;
  // shared: x1, y1, x2, y2, area (K floats each), the rank keys, then K
  // states
  float* sx1 = smem;
  float* sy1 = sx1 + K;
  float* sx2 = sy1 + K;
  float* sy2 = sx2 + K;
  float* sar = sy2 + K;
  uint32_t* skey = reinterpret_cast<uint32_t*>(sar + K);
  uint8_t* st = kShared ? reinterpret_cast<uint8_t*>(skey + K) : keep;

  // each thread visits its candidates in ascending index, so on equal
  // keys the first one it meets is the lower index
  uint32_t best_k = 0, best_i = kNone;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const uint32_t key = rank_key(S[j]);
    const bool v = V[j] != 0;
    if (kShared) {
      const float x1 = R[4 * j], y1 = R[4 * j + 1];
      const float x2 = R[4 * j + 2], y2 = R[4 * j + 3];
      sx1[j] = x1;
      sy1[j] = y1;
      sx2[j] = x2;
      sy2[j] = y2;
      sar[j] = area_of(x1, y1, x2, y2);
      skey[j] = key;
    }
    st[j] = v ? kRemaining : kDropped;
    if (v && key > best_k) {
      best_k = key;
      best_i = j;
    }
  }

  for (int round = 0; round < K; ++round) {
    uint32_t k = best_k, i = best_i;
    block_best(k, i, slot_k, slot_i, round & 1);
    if (i == kNone) break;  // the same pick in every thread
    float px1, py1, px2, py2, pa;
    if (kShared) {
      px1 = sx1[i];
      py1 = sy1[i];
      px2 = sx2[i];
      py2 = sy2[i];
      pa = sar[i];
    } else {
      px1 = R[4 * i];
      py1 = R[4 * i + 1];
      px2 = R[4 * i + 2];
      py2 = R[4 * i + 3];
      pa = area_of(px1, py1, px2, py2);
    }
    best_k = 0;
    best_i = kNone;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      if (st[j] != kRemaining) continue;
      if (j == static_cast<int>(i)) {
        st[j] = kKept;
        continue;
      }
      float x1, y1, x2, y2, ar;
      if (kShared) {
        x1 = sx1[j];
        y1 = sy1[j];
        x2 = sx2[j];
        y2 = sy2[j];
        ar = sar[j];
      } else {
        x1 = R[4 * j];
        y1 = R[4 * j + 1];
        x2 = R[4 * j + 2];
        y2 = R[4 * j + 3];
        ar = area_of(x1, y1, x2, y2);
      }
      const float ix1 = max_nan(px1, x1), iy1 = max_nan(py1, y1);
      const float ix2 = min_nan(px2, x2), iy2 = min_nan(py2, y2);
      const float inter = __fmul_rn(clamp0(__fsub_rn(ix2, ix1)),
                                    clamp0(__fsub_rn(iy2, iy1)));
      const float uni = __fsub_rn(__fadd_rn(pa, ar), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
      if (iou > a.thr) {
        st[j] = kDropped;
        continue;
      }
      const uint32_t key = kShared ? skey[j] : rank_key(S[j]);
      if (key > best_k) {
        best_k = key;
        best_i = j;
      }
    }
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    keep[j] = st[j] == kKept;
}

// Dynamic shared memory a block may opt in to on the current device, and
// the opt-in of the shared-memory instance made once per device.
int shared_limit(int* limit) {
  static std::mutex mu;
  static std::map<int, int> got;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = got.find(dev);
  if (it != got.end()) {
    *limit = it->second;
    return 0;
  }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the static reduction slots share the block's budget
  const int bytes = optin - static_cast<int>(2 * kMaxWarps * 8);
  e = cudaFuncSetAttribute(nms_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *limit = got[dev] = bytes;
  return 0;
}

}  // namespace

// S3: keep (B, K) uint8 of greedy NMS over rects (B, K, 4), scores (B, K)
// float32 and valid (B, K) uint8, all contiguous; thr the float32
// threshold.  batch >= 1, K >= 1.
extern "C" int wb_nms(const void* rects, const void* scores,
                      const void* valid, int batch, int K, float thr,
                      void* keep, void* stream) {
  if (batch < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  const int err = shared_limit(&limit);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(rects),
               static_cast<const float*>(scores),
               static_cast<const uint8_t*>(valid),
               static_cast<uint8_t*>(keep), K, thr};
  const int threads = std::min(kMaxThreads, (K + 31) / 32 * 32);
  const long long bytes = static_cast<long long>(K) * kSharedBytes;
  if (bytes <= limit)
    nms_kernel<true><<<batch, threads, static_cast<size_t>(bytes), st>>>(a);
  else
    nms_kernel<false><<<batch, threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
