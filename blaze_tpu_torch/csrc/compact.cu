// Stream compaction permutation: for a keep-mask of n rows, the stable
// list of kept row indices packed to the front, the tail [n_live, n)
// filled with 0, plus the live count n_live.
//
// Replaces the TPU kernel blaze_tpu/ops/kernels/compact_pallas.py
// (`compact_perm`, body `_compact_kernel`), and takes the place of
// `jnp.nonzero(keep, size=n, fill_value=0)` in ops/util
// `_compact_indices` - whose zero-filled tail is the contract kept
// here (not compact_perm's clipped tail). Columns then move by a
// gather through the permutation, outside this kernel.
//
// Bound on the card: bytes. A row costs one mask byte read and, if
// kept, one 4-byte index write; the least time is (n + 4 n) bytes over
// HBM bandwidth (4 n: the tail is written too). The TPU kernel built a
// 1024x1024 one-hot and contracted it on the MXU; here a warp ranks its
// 32 rows with one __ballot_sync and __popc, so the per-row work is a
// few integer instructions. Three launches:
//   1. per-block live counts (__syncthreads_count over 1024 rows);
//   2. one block scans the block counts (exclusive) and writes n_live;
//   3. every block recomputes its warps' ballots, turns the per-warp
//      counts into offsets in shared memory, and writes
//      src[block_offset + warp_offset + rank] = row; rows at or past
//      n_live write the 0 tail.
// Stability follows from ranks increasing with the row index inside a
// warp, warps in order inside a block, and blocks in order.
//
// Plain C interface, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 1024;       // rows per block = threads per block
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kRows)
block_counts(const uint8_t* __restrict__ keep, long long n,
             int* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * kRows + threadIdx.x;
  const int k = (i < n) && keep[i] != 0;
  const int c = __syncthreads_count(k);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kScanThreads)
scan_counts(const int* __restrict__ counts, int nblocks,
            int* __restrict__ offsets, int* __restrict__ n_live) {
  __shared__ int part[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nblocks + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nblocks);
  const int hi = min(lo + per, nblocks);
  int s = 0;
  for (int j = lo; j < hi; ++j) s += counts[j];
  part[t] = s;
  __syncthreads();
  // inclusive Hillis-Steele scan of the per-thread sums
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int x = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += x;
    __syncthreads();
  }
  int base = t ? part[t - 1] : 0;
  for (int j = lo; j < hi; ++j) {
    offsets[j] = base;
    base += counts[j];
  }
  if (t == kScanThreads - 1) *n_live = part[t];
}

__global__ void __launch_bounds__(kRows)
scatter_rows(const uint8_t* __restrict__ keep, long long n,
             const int* __restrict__ offsets,
             const int* __restrict__ n_live, int* __restrict__ src) {
  __shared__ int warp_off[kRows / 32];
  const long long i = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool k = (i < n) && keep[i] != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, k);
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the 32 warp counts
    const int c = warp_off[lane];
    int x = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    warp_off[lane] = x - c;
  }
  __syncthreads();
  if (k) {
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    src[offsets[blockIdx.x] + warp_off[warp] + rank] = (int)i;
  }
  if (i < n && i >= *n_live) src[i] = 0;
}

}  // namespace

extern "C" int blaze_compact_perm(const void* keep, long long n,
                                  int nblocks, void* counts, void* offsets,
                                  void* n_live, void* src, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  block_counts<<<nblocks, kRows, 0, st>>>((const uint8_t*)keep, n,
                                          (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_counts<<<1, kScanThreads, 0, st>>>((const int*)counts, nblocks,
                                          (int*)offsets, (int*)n_live);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_rows<<<nblocks, kRows, 0, st>>>((const uint8_t*)keep, n,
                                          (const int*)offsets,
                                          (const int*)n_live, (int*)src);
  return (int)cudaGetLastError();
}
