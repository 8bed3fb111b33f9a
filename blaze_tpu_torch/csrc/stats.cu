// Masked column statistics: (sum, min, max, count) over the rows whose
// mask byte is nonzero, in one pass over the column and one launch.
//
// Replaces the TPU kernel blaze_tpu/ops/kernels/stats_pallas.py
// (`masked_stats`, body `_kernel`). Unlike that kernel it does not keep
// f32 partials: the sum accumulates in the aggregate's state type
// (double for float input, two's-complement int64 for integer and bool
// input), matching the JAX package's live keyless-aggregate path.
//
// Bound on the card: bytes. Each row is read once (value + 1 mask byte)
// and costs a few selects and adds, far below the ALU rate, so the
// least time is (value bytes + mask bytes) / HBM bandwidth. The design:
//
//   - The column in its own dtype (bool, int8-64, float32/64), widened
//     in registers. Min and max compare integer keys: the value itself
//     for integers (int for bool, int8 and int16; a bool's min is its
//     AND, its max its OR), for floats the bits mapped to a signed
//     integer of the same order, which puts -0.0 below +0.0 and a NaN
//     past the infinities, so a kept NaN shows in min or max and then
//     wins both (jnp.min / jnp.max semantics). A row costs two integer
//     min/max, two selects and the sum's add; the count is a popcount
//     of the mask's nonzero bytes.
//   - Independent vector loads: a thread loads kUnroll 16-byte vectors
//     of values, kThreads vectors apart (a warp reads 512 contiguous
//     bytes a load), and the mask bytes of the same rows, before it
//     uses any of them. The mask is applied with selects, not a branch,
//     so no load waits on another.
//   - Any storage offset: the rows before the values' first 16-byte
//     boundary (the head) and after the last whole vector (the tail)
//     are read one by one by block 0. A mask whose bytes do not line up
//     with the value vectors is read byte by byte, still before use.
//     Nothing past row n is read.
//   - One launch. Each block folds its threads' states (warp shuffles,
//     then shared memory). A grid of one block writes the results
//     directly. Otherwise each block writes its partial to scratch,
//     fences and takes a ticket with atomicAdd; the first warp of the
//     block that takes the last ticket folds the partials in a fixed
//     order, writes the four results and resets the ticket to 0. No
//     memset, no second launch, no float atomics: the fold order
//     depends only on n, the grid and the pointers' alignment, so a
//     repeated call gives the same bits. One block takes columns of up
//     to 64 KiB (the q6 batch), where a second block's ticket costs
//     more than it saves.
//
// The scratch (kMaxBlocks partials of four 64-bit words, then the
// 32-bit ticket) belongs to the caller: zeroed once and kept for one
// stream, so two streams never share a ticket. A launch that fails
// part-way can leave the ticket nonzero; the caller then discards that
// stream's scratch.
//
// Integer sums add as unsigned 64-bit, which wraps without undefined
// behaviour (a vector's int8, int16 or bool rows first add in int).
//
// Plain C interface, loaded with ctypes. Each entry launches on the
// given stream, allocates nothing, and returns cudaGetLastError().
// Results go to one 32-byte buffer: the sum at byte 0, the count at 8,
// min at 16 and max right after it, in the column's dtype.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;        // value vectors in flight a thread
constexpr int kVec = 16;          // bytes a vector load
constexpr int kMaxBlocks = 1024;  // partials the scratch holds

// Per column dtype: S its storage, Key the ordered integer that min and
// max compare, A the sum's type, P a vector's partial sum (int where 16
// rows of the dtype cannot overflow it). key() is monotone in the value
// and puts -0.0 below +0.0; lowest() and highest() are the keys of the
// least and greatest values (-inf and +inf for floats). A float NaN's
// key lies outside them (above +inf for a positive NaN, below -inf for
// a negative one), so a kept NaN shows in min or max at the end, and
// then wins both.
struct Bool {};  // tag: a torch.bool column, one byte (0 or 1) a row

// float bits -> a signed integer of the same order (an involution)
__device__ __forceinline__ int32_t fkey(int32_t b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ long long fkey(long long b) {
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}

template <typename K> struct Kind;
template <> struct Kind<float> {
  typedef float S;
  typedef int32_t Key;
  typedef double A;
  typedef double P;
  __device__ static Key key(S x) { return fkey(__float_as_int(x)); }
  __device__ static S value(Key k) { return __int_as_float(fkey(k)); }
  __device__ static S qnan() { return __int_as_float(0x7fc00000); }
  __device__ static P part(S x) { return (double)x; }
  __device__ static Key lowest() { return fkey((int32_t)0xff800000); }
  __device__ static Key highest() { return fkey((int32_t)0x7f800000); }
};
template <> struct Kind<double> {
  typedef double S;
  typedef long long Key;
  typedef double A;
  typedef double P;
  __device__ static Key key(S x) { return fkey(__double_as_longlong(x)); }
  __device__ static S value(Key k) { return __longlong_as_double(fkey(k)); }
  __device__ static S qnan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  __device__ static P part(S x) { return x; }
  __device__ static Key lowest() {
    return fkey((long long)0xfff0000000000000ULL);
  }
  __device__ static Key highest() { return fkey(0x7ff0000000000000LL); }
};
template <typename S_, typename Key_, typename P_, long long kLo,
          long long kHi>
struct IntKind {
  typedef S_ S;
  typedef Key_ Key;
  typedef unsigned long long A;
  typedef P_ P;
  __device__ static Key key(S x) { return (Key)x; }
  __device__ static S value(Key k) { return (S)k; }
  __device__ static S qnan() { return 0; }
  __device__ static P part(S x) { return (P)(long long)x; }
  __device__ static Key lowest() { return (Key)kLo; }
  __device__ static Key highest() { return (Key)kHi; }
};
template <> struct Kind<int8_t>
    : IntKind<int8_t, int, int, INT8_MIN, INT8_MAX> {};
template <> struct Kind<int16_t>
    : IntKind<int16_t, int, int, INT16_MIN, INT16_MAX> {};
template <> struct Kind<int32_t>
    : IntKind<int32_t, int32_t, unsigned long long, INT32_MIN, INT32_MAX> {};
template <> struct Kind<int64_t>
    : IntKind<int64_t, long long, unsigned long long, INT64_MIN, INT64_MAX> {};
template <> struct Kind<Bool> : IntKind<uint8_t, int, int, 0, 1> {
  __device__ static Key key(S x) { return x != 0; }
};

template <typename K> struct State {
  typename Kind<K>::A sum;
  typename Kind<K>::Key lo;
  typename Kind<K>::Key hi;
  unsigned long long cnt;
};

template <typename K> __device__ __forceinline__ State<K> neutral() {
  State<K> s;
  s.sum = 0;
  s.lo = Kind<K>::highest();
  s.hi = Kind<K>::lowest();
  s.cnt = 0;
  return s;
}

template <typename X> __device__ __forceinline__ X min2(X a, X b) {
  return b < a ? b : a;
}
template <typename X> __device__ __forceinline__ X max2(X a, X b) {
  return b > a ? b : a;
}

template <typename K>
__device__ __forceinline__ void fold(State<K>& a, const State<K>& b) {
  a.sum += b.sum;
  a.lo = min2(a.lo, b.lo);
  a.hi = max2(a.hi, b.hi);
  a.cnt += b.cnt;
}

template <typename K>
__device__ __forceinline__ void fold_down(State<K>& s, int off) {
  State<K> o;
  o.sum = __shfl_down_sync(0xffffffffu, s.sum, off);
  o.lo = __shfl_down_sync(0xffffffffu, s.lo, off);
  o.hi = __shfl_down_sync(0xffffffffu, s.hi, off);
  o.cnt = __shfl_down_sync(0xffffffffu, s.cnt, off);
  fold(s, o);
}

// Fold the block's states into thread 0's, in a fixed order.
template <typename K>
__device__ __forceinline__ State<K> block_fold(State<K> s) {
  __shared__ State<K> warp_states[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) fold_down(s, off);
  if (lane == 0) warp_states[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_states[lane] : neutral<K>();
    for (int off = 16; off > 0; off >>= 1) fold_down(s, off);
  }
  return s;
}

// One row's value joins min and max where `keep` holds (selects, no
// branch); its share of the sum goes to `part`.
template <typename K>
__device__ __forceinline__ void take(State<K>& s, typename Kind<K>::P& part,
                                     typename Kind<K>::S x, bool keep) {
  typedef Kind<K> T;
  part += T::part(keep ? x : (typename T::S)0);
  const typename T::Key k = T::key(x);
  s.lo = min2(s.lo, keep ? k : T::highest());
  s.hi = max2(s.hi, keep ? k : T::lowest());
}

// One 16-byte vector of values, and the mask bytes of its RU rows as
// 32-bit words (byte j of the rows in bits 8 (j % 4) of word j / 4).
template <typename S> union Vec {
  uint4 q;
  S e[kVec / sizeof(S)];
};
template <int RU> struct MaskWords {
  uint32_t w[(RU + 3) / 4];
};

// The RU mask bytes at p: one load of RU bytes when p is RU-aligned
// (kVecMask), else RU byte loads; either way issued before any use.
template <int RU, bool kVecMask>
__device__ __forceinline__ MaskWords<RU> load_mask(const uint8_t* p) {
  MaskWords<RU> b;
  if constexpr (kVecMask && RU == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    b.w[0] = q.x;
    b.w[1] = q.y;
    b.w[2] = q.z;
    b.w[3] = q.w;
  } else if constexpr (kVecMask && RU == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    b.w[0] = q.x;
    b.w[1] = q.y;
  } else if constexpr (kVecMask && RU == 4) {
    b.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (kVecMask && RU == 2) {
    b.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < (RU + 3) / 4; ++i) b.w[i] = 0;
#pragma unroll
    for (int j = 0; j < RU; ++j)
      b.w[j >> 2] |= (uint32_t)__ldg(p + j) << (8 * (j & 3));
  }
  return b;
}

// bit 7 of each byte of the result is set where that byte of w is
// nonzero (a uint8 mask may hold 2..255); the other bits are 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// The RU rows of one vector: the count from the mask's popcount, the
// sum through a partial of type P.
template <typename K, int RU>
__device__ __forceinline__ void take_vec(State<K>& s,
                                         const Vec<typename Kind<K>::S>& x,
                                         const MaskWords<RU>& b) {
  typename Kind<K>::P part = 0;
  unsigned int c = 0;
#pragma unroll
  for (int i = 0; i < (RU + 3) / 4; ++i) {
    const uint32_t h = nonzero_bytes(b.w[i]);
    c += __popc(h);
#pragma unroll
    for (int j = 0; j < 4 && 4 * i + j < RU; ++j)
      take(s, part, x.e[4 * i + j], (h >> (8 * j + 7)) & 1u);
  }
  s.sum += (typename Kind<K>::A)part;
  s.cnt += c;
}

// a partial's field as a 64-bit scratch word, and back
template <typename X>
__device__ __forceinline__ unsigned long long word(X x) {
  unsigned long long w = 0;
  memcpy(&w, &x, sizeof(X));
  return w;
}
template <typename X>
__device__ __forceinline__ X unword(unsigned long long w) {
  X x;
  memcpy(&x, &w, sizeof(X));
  return x;
}

template <typename K>
__device__ __forceinline__ void store(unsigned char* out, const State<K>& s) {
  typedef Kind<K> T;
  typedef typename T::S S;
  *reinterpret_cast<typename T::A*>(out) = s.sum;
  *reinterpret_cast<unsigned long long*>(out + 8) = s.cnt;
  const bool nan = s.hi > T::highest() || s.lo < T::lowest();
  // volatile: ptxas (CUDA 12.9, sm_90a) merged the two int16 stores
  // into one 32-bit store assembled from the wrong register
  volatile S* ext = reinterpret_cast<volatile S*>(out + 16);
  ext[0] = nan ? T::qnan() : T::value(s.lo);
  ext[1] = nan ? T::qnan() : T::value(s.hi);
}

// Rows [0, head) and [head + units * RU, n) one by one (block 0); the
// units whole 16-byte vectors from row head, kUnroll a thread a round.
template <typename K, bool kVecMask>
__global__ void __launch_bounds__(kThreads)
masked_stats_kernel(const typename Kind<K>::S* __restrict__ v,
                    const uint8_t* __restrict__ m, long long n,
                    long long head, long long units,
                    unsigned long long* __restrict__ part,
                    unsigned int* __restrict__ ticket,
                    unsigned char* __restrict__ out) {
  typedef Kind<K> T;
  typedef typename T::S S;
  constexpr int RU = kVec / sizeof(S);
  State<K> s = neutral<K>();
  if (blockIdx.x == 0) {
    const long long tail = head + units * RU;
    const int t = threadIdx.x;
    typename T::P p = 0;
    if (t < head) {
      const bool keep = m[t] != 0;
      take(s, p, v[t], keep);
      s.cnt += keep;
    }
    if (t < n - tail) {
      const bool keep = m[tail + t] != 0;
      take(s, p, v[tail + t], keep);
      s.cnt += keep;
    }
    s.sum += (typename T::A)p;
  }
  const uint4* vv = reinterpret_cast<const uint4*>(v + head);
  const uint8_t* mm = m + head;
  const long long step = (long long)gridDim.x * (kThreads * kUnroll);
  for (long long u0 = (long long)blockIdx.x * (kThreads * kUnroll) +
                      threadIdx.x;
       u0 < units; u0 += step) {
    Vec<S> x[kUnroll];
    MaskWords<RU> b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = u0 + (long long)k * kThreads;
      if (u < units) {
        x[k].q = __ldg(vv + u);
        b[k] = load_mask<RU, kVecMask>(mm + u * RU);
      } else {
        x[k].q = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < (RU + 3) / 4; ++i) b[k].w[i] = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) take_vec<K, RU>(s, x[k], b[k]);
  }
  s = block_fold(s);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) store(out, s);
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    // four words a block: sum, min key, max key, count
    unsigned long long* p = part + 4 * blockIdx.x;
    p[0] = word(s.sum);
    p[1] = word(s.lo);
    p[2] = word(s.hi);
    p[3] = s.cnt;
    __threadfence();  // the partial is visible before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // the last block's first warp folds the partials, lane i taking
  // i, i + 32, ... and the lanes then folding by shuffles
  __threadfence();  // every partial is visible after the last ticket
  State<K> a = neutral<K>();
  for (int i = threadIdx.x; i < (int)gridDim.x; i += 32) {
    const unsigned long long* p = part + 4 * i;
    State<K> q;
    q.sum = unword<typename T::A>(__ldcg(p));
    q.lo = unword<typename T::Key>(__ldcg(p + 1));
    q.hi = unword<typename T::Key>(__ldcg(p + 2));
    q.cnt = __ldcg(p + 3);
    fold(a, q);
  }
  for (int off = 16; off > 0; off >>= 1) fold_down(a, off);
  if (threadIdx.x == 0) {
    store(out, a);
    *ticket = 0;
  }
}

template <typename K>
int launch(const void* v, const void* m, long long n, int nblocks,
           void* scratch, void* out, void* stream) {
  typedef typename Kind<K>::S S;
  constexpr int RU = kVec / sizeof(S);
  const uintptr_t pv = (uintptr_t)v;
  const uintptr_t pm = (uintptr_t)m;
  if (n < 0 || nblocks < 1 || nblocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  if (pv % sizeof(S) != 0) return (int)cudaErrorMisalignedAddress;
  long long head = (long long)((kVec - pv % kVec) % kVec / sizeof(S));
  if (head > n) head = n;
  const long long units = (n - head) / RU;
  unsigned long long* part = (unsigned long long*)scratch;
  unsigned int* ticket = (unsigned int*)(part + 4 * kMaxBlocks);
  cudaStream_t st = (cudaStream_t)stream;
  if ((pm + head) % RU == 0)
    masked_stats_kernel<K, true><<<nblocks, kThreads, 0, st>>>(
        (const S*)v, (const uint8_t*)m, n, head, units, part, ticket,
        (unsigned char*)out);
  else
    masked_stats_kernel<K, false><<<nblocks, kThreads, 0, st>>>(
        (const S*)v, (const uint8_t*)m, n, head, units, part, ticket,
        (unsigned char*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define BLAZE_STATS_ENTRY(NAME, K)                                        \
  extern "C" int NAME(const void* v, const void* m, long long n,         \
                      int nblocks, void* scratch, void* out,             \
                      void* stream) {                                    \
    return launch<K>(v, m, n, nblocks, scratch, out, stream);            \
  }

BLAZE_STATS_ENTRY(blaze_masked_stats_b8, Bool)
BLAZE_STATS_ENTRY(blaze_masked_stats_i8, int8_t)
BLAZE_STATS_ENTRY(blaze_masked_stats_i16, int16_t)
BLAZE_STATS_ENTRY(blaze_masked_stats_i32, int32_t)
BLAZE_STATS_ENTRY(blaze_masked_stats_i64, int64_t)
BLAZE_STATS_ENTRY(blaze_masked_stats_f32, float)
BLAZE_STATS_ENTRY(blaze_masked_stats_f64, double)
