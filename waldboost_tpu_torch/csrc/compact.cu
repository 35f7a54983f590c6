// S2: the exact, order-keeping compaction of a masked score map.
//
//  wb_compact_count  per image, the finite entries of each 4096-entry
//                    block, then their exclusive scan (block offsets) and
//                    total.
//  wb_compact_write  per image, the finite entries in flat-index order,
//                    then the first non-finite ones in flat-index order,
//                    into n_out slots: (score, flat index) pairs.
//
// Replaces the XLA op of two-phase serving
// jax.lax.approx_max_k(masked, cap, recall_target=1.0)
// (waldboost_tpu/parallel/detect.py:759, in
// _make_two_phase_detector_boxes), which JAX runs in XLA (a sort); JAX
// has no kernel here.  The host (ops/nms.py::compact_survivors) then
// sorts the n_out pairs stably by score descending, so the first cap are
// the stable descending sort of the whole map cut to cap: the top cap
// finite entries by (score descending, flat index ascending), and where
// fewer are finite, the non-finite ones by flat index.  n_out is cap, or
// on overflow (more than cap finite entries) the largest count.
//
// Design: one thread block a (4096-entry block, image); the block walks
// its entries in 16 rounds of 256, each thread one entry a round, so the
// loads are coalesced.  In the write pass an entry's position is its
// block's offset plus the finite entries before it in the block: a warp
// ballot and popc within the warp, the warps' counts through shared
// memory.  A non-finite entry at flat index j goes to total + (j - the
// finite entries before j).  The scan of block counts is one block an
// image (a thread a run of blocks, then a shared-memory scan of the
// runs).  Bound: the map read twice and the n_out pairs written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // entries a block
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool finite(float v) { return isfinite(v); }

// The exclusive prefix, over the block in thread order, of one flag a
// thread, and the block's total.  Every thread of the block calls it.
__device__ __forceinline__ int block_prefix(bool flag, int* s_warp,
                                            int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    const int c = s_warp[w];
    if (w < warp) before += c;
    total += c;
  }
  __syncthreads();
  return before + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const float* __restrict__ masked, long long n, int n_blocks,
                 int* __restrict__ counts) {
  __shared__ int s_warp[kThreads / 32];
  const int b = blockIdx.y;
  const float* row = masked + static_cast<size_t>(b) * n;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int mine = 0;
  for (int k = 0; k < kRounds; ++k) {
    const long long j = base + k * kThreads + threadIdx.x;
    mine += j < n && finite(__ldg(row + j));
  }
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_down_sync(0xffffffffu, mine, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_warp[w];
    counts[static_cast<size_t>(b) * n_blocks + blockIdx.x] = sum;
  }
}

// In place: counts become exclusive offsets; totals[b] the image's sum.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ counts, int n_blocks,
                int* __restrict__ totals) {
  __shared__ int s_run[kScanThreads];
  const int b = blockIdx.x;
  int* c = counts + static_cast<size_t>(b) * n_blocks;
  const int per = (n_blocks + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n_blocks);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += c[i];
  s_run[threadIdx.x] = sum;
  __syncthreads();
  // Hillis-Steele inclusive scan of the runs
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? s_run[threadIdx.x - off] : 0;
    __syncthreads();
    s_run[threadIdx.x] += v;
    __syncthreads();
  }
  int at = s_run[threadIdx.x] - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = c[i];
    c[i] = at;
    at += v;
  }
  if (threadIdx.x == kScanThreads - 1) totals[b] = s_run[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const float* __restrict__ masked, long long n, int n_blocks,
                 const int* __restrict__ offsets,
                 const int* __restrict__ totals, int n_out,
                 float* __restrict__ scores, long long* __restrict__ index) {
  __shared__ int s_warp[kThreads / 32];
  const int b = blockIdx.y;
  const float* row = masked + static_cast<size_t>(b) * n;
  float* out_s = scores + static_cast<size_t>(b) * n_out;
  long long* out_i = index + static_cast<size_t>(b) * n_out;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long total = totals[b];
  long long before = offsets[static_cast<size_t>(b) * n_blocks + blockIdx.x];
  for (int k = 0; k < kRounds; ++k) {
    if (base + k * kThreads >= n) break;  // the same for the whole block
    const long long j = base + k * kThreads + threadIdx.x;
    const float v = j < n ? __ldg(row + j) : 0.0f;
    const bool fin = j < n && finite(v);
    int round_total;
    const long long at = before + block_prefix(fin, s_warp, round_total);
    if (j < n) {
      // finite: its rank among the finite entries; else after all of them
      const long long pos = fin ? at : total + (j - at);
      if (pos < n_out) {
        out_s[pos] = v;
        out_i[pos] = j;
      }
    }
    before += round_total;
  }
}

}  // namespace

// Per image of the (B, n) float32 map: counts (B, n_blocks) block
// offsets, totals (B,) finite entries.  n_blocks = ceil(n / 4096).
extern "C" int wb_compact_count(const void* masked, int batch, long long n,
                                int n_blocks, void* counts, void* totals,
                                void* stream) {
  if (batch >= 65536 || n_blocks != (n + kTile - 1) / kTile ||
      n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    count_kernel<<<dim3(n_blocks, batch), kThreads, 0, st>>>(
        static_cast<const float*>(masked), n, n_blocks,
        static_cast<int*>(counts));
    scan_kernel<<<batch, kScanThreads, 0, st>>>(
        static_cast<int*>(counts), n_blocks, static_cast<int*>(totals));
  }
  return static_cast<int>(cudaGetLastError());
}

// The (B, n_out) scores and int64 flat indices of the compacted map, from
// wb_compact_count's offsets and totals.
extern "C" int wb_compact_write(const void* masked, int batch, long long n,
                                int n_blocks, const void* offsets,
                                const void* totals, int n_out, void* scores,
                                void* index, void* stream) {
  if (batch >= 65536 || n_blocks != (n + kTile - 1) / kTile || n_out < 0 ||
      n_out > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && n > 0 && n_out > 0) {
    write_kernel<<<dim3(n_blocks, batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(masked), n, n_blocks,
        static_cast<const int*>(offsets), static_cast<const int*>(totals),
        n_out, static_cast<float*>(scores), static_cast<long long*>(index));
  }
  return static_cast<int>(cudaGetLastError());
}
