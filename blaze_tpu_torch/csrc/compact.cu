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
// Bound on the card: bytes. A row costs one mask byte read and one
// 4-byte write (a kept index or the 0 tail); the least time is 5 n
// bytes over HBM bandwidth. The TPU kernel built a 1024x1024 one-hot and
// contracted it on the MXU; on Hopper the work per row is a few integer
// instructions, and what matters is keeping enough bytes in flight and
// not serialising the card between passes. Two kernels, one launch per
// call:
//
//   - Each thread loads its rows as 16-byte vectors and turns each into
//     a 16-bit mask of the nonzero bytes (not their sum: uint8 masks may
//     hold 2..255). A mask that is a view can start at any byte: tiles
//     are laid on the 16-byte grid below the first row, and the two
//     vectors that straddle the mask's ends are read byte by byte, in
//     bounds.
//   - Ranks: __popc of the masks, a warp-shuffle scan and a scan of the
//     warp totals in shared memory. The kept indices are staged in
//     shared memory in order and written out contiguously, 16-byte
//     stores between a scalar head and tail.
//
// compact_small, up to kSmallRows rows (the engine's batches and most of
// its hash tables): block t takes tile t of kPass rows and also counts
// the kept rows of every other tile (at most 16 vectors a thread, from
// L2 after the first block), so it knows its offset and n_live without
// waiting on any other block. It writes its share of the 0 tail, the
// src positions of its own tile's range at or past n_live. No scratch,
// no memset, no inter-block wait.
//
// compact_lookback, past kSmallRows: a chained scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016):
//
//   - A block claims tiles of kTile rows from an atomic counter (not
//     blockIdx), so a tile only ever waits on tiles that running blocks
//     already hold: look-back makes progress under any scheduling order
//     and any grid size.
//   - The tile publishes its count (flag AGG) at once, then looks back
//     over its predecessors' status words with one warp, 32 at a time,
//     summing counts until it meets an inclusive prefix (flag INC), and
//     publishes its own inclusive prefix. Status words are 64-bit (flag
//     in the high half, value in the low), stored with release and read
//     with acquire at gpu scope.
//   - The last tile writes n_live and posts it in a done word. A block
//     leaves its claim loop only when a claim comes back past the last
//     tile, so every tile is then held by a running block; only then
//     does it wait for the done word and write its share of the 0 tail
//     [n_live, n). So the wait ends whatever the grid and however few
//     of its blocks are resident. Both waits trap after 10 s rather
//     than hold the card.
//   - One cudaMemsetAsync in the same C entry clears the tile counter,
//     the done word and the status words.
//
// No host sync. Stability: a thread's rows are in order, threads in
// order inside a vector pass, the passes in order inside a tile, tiles
// in order.
//
// Plain C interface, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                      // mask bytes per vector load
constexpr int kPass = kThreads * kVec;        // rows per vector pass
constexpr int kTile = 2 * kPass;              // rows per look-back tile
constexpr int kWarps = kThreads / 32;
// up to this many rows, compact_small (each block counts every tile;
// a mask that starts off the 16-byte grid spans one tile more)
constexpr long long kSmallRows = 16 * kPass;
constexpr int kSmallTiles = 17;

constexpr unsigned long long kFlagAgg = 1ull << 32;
constexpr unsigned long long kFlagInc = 2ull << 32;

// Scratch the wrapper allocates after the n_live word for the look-back
// kernel: tile counter, done word (n_live + 1 once known), then one
// status word per tile.
struct Scratch {
  unsigned int next_tile;
  unsigned int done;
  unsigned long long pad;
  unsigned long long status[1];
};

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.global.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.global.acquire.gpu.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release32(unsigned int* p,
                                             unsigned int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned int ld_acquire32(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The look-back and the tail's wait end within microseconds; one that
// outlasts this is a fault: trap, so that it surfaces as a launch error
// and does not hold the card.
constexpr unsigned long long kWaitLimitNs = 10000000000ull;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 4 bits, one per nonzero byte of w (byte j -> bit j)
__device__ __forceinline__ unsigned int nonzero4(unsigned int w) {
  const unsigned int hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  // bits 7, 15, 23, 31 -> 28, 29, 30, 31; no two partial products meet
  return (hi * 0x00204081u) >> 28;
}

__device__ __forceinline__ unsigned int nonzero16(uint4 w) {
  return nonzero4(w.x) | (nonzero4(w.y) << 4) | (nonzero4(w.z) << 8) |
         (nonzero4(w.w) << 12);
}

// 16-bit mask of the nonzero bytes at virtual positions [p, p + 16) of
// the 16-byte grid at `base`; rows are the positions [lo, hi).
__device__ __forceinline__ unsigned int load_mask(const uint8_t* base,
                                                  long long p, long long lo,
                                                  long long hi) {
  if (p >= lo && p + kVec <= hi)
    return nonzero16(*reinterpret_cast<const uint4*>(base + p));
  unsigned int m = 0;
  if (p + kVec > lo && p < hi) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long q = p + j;
      if (q >= lo && q < hi && base[q] != 0) m |= 1u << j;
    }
  }
  return m;
}

// Stage the kept rows of one 16-row vector at stage[pos...] in order.
__device__ __forceinline__ void stage_rows(int* stage, int pos, unsigned int m,
                                           long long r0) {
  while (m) {
    stage[pos++] = (int)(r0 + __ffs(m) - 1);
    m &= m - 1;
  }
}

// src[offset, offset + count) = stage[0, count), 16-byte stores between
// a scalar head and tail; all threads of the block.
__device__ __forceinline__ void write_staged(int* __restrict__ src,
                                             const int* stage,
                                             unsigned int offset,
                                             unsigned int count) {
  const int tid = threadIdx.x;
  const int lead = (int)min((4u - (offset & 3u)) & 3u, count);
  if (tid < lead) src[offset + tid] = stage[tid];
  const int vecs = (int)(count - lead) >> 2;
  int4* dst = reinterpret_cast<int4*>(src + offset + lead);
  for (int q = tid; q < vecs; q += kThreads) {
    const int e = lead + 4 * q;
    dst[q] = make_int4(stage[e], stage[e + 1], stage[e + 2], stage[e + 3]);
  }
  const int done = lead + 4 * vecs;
  if (tid < (int)count - done) src[offset + done + tid] = stage[done + tid];
}

// src[a, b) = 0 by thread i of `stride`, 16-byte stores between scalar
// ends (src is 16-byte aligned).
__device__ __forceinline__ void zero_range(int* __restrict__ src, long long a,
                                           long long b, long long i,
                                           long long stride) {
  if (a >= b) return;
  const long long va = (a + 3) >> 2, vb = b >> 2;  // whole int4s in [a, b)
  if (va >= vb) {
    for (long long q = a + i; q < b; q += stride) src[q] = 0;
    return;
  }
  if (a + i < 4 * va) src[a + i] = 0;
  if (4 * vb + i < b) src[4 * vb + i] = 0;
  int4* dst = reinterpret_cast<int4*>(src);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (long long q = va + i; q < vb; q += stride) dst[q] = zero;
}

__device__ __forceinline__ unsigned int warp_sum(unsigned int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per tile of kPass rows; gridDim.x <= kSmallTiles tiles cover
// [head, head + n).
__global__ void __launch_bounds__(kThreads)
compact_small(const uint8_t* __restrict__ base, long long head, long long n,
              int* __restrict__ src, int* __restrict__ n_live) {
  __shared__ int stage[kPass];
  __shared__ unsigned int warp_own[kWarps], warp_before[kWarps],
      warp_all[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.x;
  const long long hi = head + n;
  const long long p0 = (long long)t * kPass + (long long)tid * kVec;

  const unsigned int m = load_mask(base, p0, head, hi);
  // the kept rows of this thread's vector in every tile: all loads in
  // flight at once; the two vectors that straddle the mask's ends (0 in
  // w) byte by byte after. `before` counts the tiles before this one.
  uint4 w[kSmallTiles];
#pragma unroll
  for (int u = 0; u < kSmallTiles; ++u) {
    const long long p = (long long)u * kPass + (long long)tid * kVec;
    w[u] = p >= head && p + kVec <= hi
               ? *reinterpret_cast<const uint4*>(base + p)
               : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned int before = 0, all = 0;
#pragma unroll
  for (int u = 0; u < kSmallTiles; ++u) {
    const unsigned int c = __popc(nonzero16(w[u]));
    before += u < t ? c : 0u;
    all += c;
  }
  const long long last = (hi - 1) & ~(long long)(kVec - 1);
  if (tid == 0 && head > 0) {  // the first vector (tile 0)
    const unsigned int c = __popc(load_mask(base, 0, head, hi));
    before += t > 0 ? c : 0u;
    all += c;
  }
  if ((hi & (kVec - 1)) != 0 && !(head > 0 && last == 0) &&
      last % kPass == (long long)tid * kVec) {  // the last, if not the first
    const unsigned int c = __popc(load_mask(base, last, head, hi));
    before += last / kPass < t ? c : 0u;
    all += c;
  }
  const unsigned int own = __popc(m);
  unsigned int x = own;  // inclusive warp scan
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  before = warp_sum(before);
  all = warp_sum(all);
  if (lane == 31) warp_own[warp] = x;
  if (lane == 0) {
    warp_before[warp] = before;
    warp_all[warp] = all;
  }
  __syncthreads();
  unsigned int excl = x - own, count = 0, offset = 0, live = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    excl += v < warp ? warp_own[v] : 0u;
    count += warp_own[v];
    offset += warp_before[v];
    live += warp_all[v];
  }
  stage_rows(stage, (int)excl, m, p0 - head);
  __syncthreads();
  write_staged(src, stage, offset, count);
  if (t == (int)gridDim.x - 1 && tid == 0) *n_live = (int)live;
  // the 0 tail: this block's share is its own kPass positions of src
  const long long lo = (long long)t * kPass;
  zero_range(src, max(lo, (long long)live), min(lo + kPass, n), tid,
             kThreads);
}

// Sum of the counts of tiles [0, t) by decoupled look-back; warp 0 only.
__device__ __forceinline__ unsigned int look_back(
    unsigned long long* status, int t, int lane) {
  unsigned int exclusive = 0;
  int window_end = t;  // predecessors [window_end - 32, window_end)
  while (true) {
    const int j = window_end - 1 - lane;  // lane 0: nearest predecessor
    unsigned long long s;
    const unsigned long long t0 = now_ns();
    while (true) {  // every lane re-reads until no lane sees an unpublished word
      s = j >= 0 ? ld_acquire(status + j) : kFlagInc;  // before tile 0: 0
      if (!__any_sync(0xffffffffu, (s >> 32) == 0)) break;
      if (now_ns() - t0 > kWaitLimitNs) __trap();
    }
    // lanes past an inclusive prefix do not count
    const unsigned int inc = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 32;  // nearest INC lane
    exclusive += warp_sum((lane <= stop && j >= 0) ? (unsigned int)s : 0u);
    if (inc) return exclusive;
    window_end -= 32;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_lookback(const uint8_t* __restrict__ base, long long head,
                 long long n, int ntiles, int* __restrict__ src,
                 int* __restrict__ n_live, Scratch* __restrict__ scratch) {
  __shared__ int stage[kTile];
  __shared__ unsigned int warp_own[kWarps];
  __shared__ int s_tile;
  __shared__ unsigned int s_offset;
  __shared__ unsigned int s_live;  // n_live, once this block knows it
  __shared__ int s_last;           // this block held the last tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long hi = head + n;  // rows are the positions [head, hi)
  if (tid == 0) s_last = 0;

  // claim tiles until a claim comes back past the last one
  while (true) {
    if (tid == 0) s_tile = (int)atomicAdd(&scratch->next_tile, 1u);
    __syncthreads();
    const int t = s_tile;
    if (t >= ntiles) break;

    const long long p0 = (long long)t * kTile + (long long)tid * kVec;
    const unsigned int m0 = load_mask(base, p0, head, hi);
    const unsigned int m1 = load_mask(base, p0 + kPass, head, hi);
    const unsigned int own = __popc(m0) | ((unsigned int)__popc(m1) << 16);

    // packed inclusive scan: both passes' counts at once (each <= 4096)
    unsigned int x = own;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_own[warp] = x;
    __syncthreads();
    unsigned int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned int s = warp_own[w];
      before += w < warp ? s : 0u;
      total += s;
    }
    const unsigned int excl = before + x - own;
    const unsigned int pass0 = total & 0xffffu;
    const unsigned int count = pass0 + (total >> 16);

    // publish this tile's count at once, so successors need not wait
    if (tid == 0) {
      if (t == 0) {
        st_release(scratch->status, kFlagInc | count);
      } else {
        st_release(scratch->status + t, kFlagAgg | count);
      }
    }

    // stage the kept row indices in order
    stage_rows(stage, (int)(excl & 0xffffu), m0, p0 - head);
    stage_rows(stage, (int)(pass0 + (excl >> 16)), m1, p0 + kPass - head);

    if (warp == 0) {
      unsigned int offset = 0;
      if (t > 0) {
        offset = look_back(scratch->status, t, lane);
        if (lane == 0) st_release(scratch->status + t, kFlagInc | (offset + count));
      }
      if (lane == 0) {
        s_offset = offset;
        if (t == ntiles - 1) {
          *n_live = (int)(offset + count);
          st_release32(&scratch->done, offset + count + 1u);
          s_last = 1;
          s_live = offset + count;
        }
      }
    }
    __syncthreads();
    write_staged(src, stage, s_offset, count);
    __syncthreads();  // stage and s_tile are reused by the next tile
  }

  // every tile is held by a running block: wait for the last tile's
  // count and write this block's share of the 0 tail
  if (tid == 0 && !s_last) {
    unsigned int d;
    const unsigned long long t0 = now_ns();
    while ((d = ld_acquire32(&scratch->done)) == 0) {
      if (now_ns() - t0 > kWaitLimitNs) __trap();
      __nanosleep(100);
    }
    s_live = d - 1u;
  }
  __syncthreads();
  zero_range(src, s_live, n, (long long)blockIdx.x * kThreads + tid,
             (long long)gridDim.x * kThreads);
}

static_assert(sizeof(Scratch) == 24, "scratch layout");

// bytes of scratch for ntiles look-back tiles (ops/kernels/compact.py
// allocates the same: 16 + 8 ntiles)
long long scratch_bytes(int ntiles) { return 16 + 8 * (long long)ntiles; }

}  // namespace

// keep: the mask's first byte (any alignment); n rows; src: 16-byte
// aligned int32 (n,); n_live: int32 (1,). Up to kSmallRows rows, one
// compact_small launch (ntiles, nblocks and scratch unused). Past it,
// ntiles look-back tiles on the 16-byte grid below the first row, run by
// nblocks blocks; scratch: scratch_bytes(ntiles) of 8-byte aligned
// memory, cleared here.
extern "C" int blaze_compact_perm(const void* keep, long long n, int ntiles,
                                  int nblocks, void* src, void* n_live,
                                  void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t addr = (uintptr_t)keep;
  const long long head = (long long)(addr & (kVec - 1));
  const uint8_t* base = (const uint8_t*)(addr - (uintptr_t)head);
  if (n <= kSmallRows) {
    const int tiles = (int)((head + n + kPass - 1) / kPass);
    compact_small<<<tiles > 0 ? tiles : 1, kThreads, 0, st>>>(
        base, head, n, (int*)src, (int*)n_live);
    return (int)cudaGetLastError();
  }
  if (ntiles < 1 || nblocks < 1 || (long long)ntiles * kTile < head + n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, (size_t)scratch_bytes(ntiles), st);
  if (err != cudaSuccess) return (int)err;
  compact_lookback<<<nblocks, kThreads, 0, st>>>(
      base, head, n, ntiles, (int*)src, (int*)n_live, (Scratch*)scratch);
  return (int)cudaGetLastError();
}
