// Segmented reduction: out[s] = sum / min / max of v[i] over the rows i
// with gid[i] == s (and contrib[i] != 0, when a mask is given), for s in
// [0, k). Rows whose gid lies outside [0, k) contribute nowhere. An empty
// segment holds the neutral element: 0 for sums, +inf / INT_MAX for min,
// -inf / INT_MIN for max.
//
// Replaces the TPU kernel blaze_tpu/ops/kernels/segreduce_pallas.py
// (`segment_sum` / `segment_minmax`, bodies `_sum_kernel` and
// `_minmax_kernel`). That kernel contracts a (rows x k) one-hot on the
// MXU, f32 only, k <= 8192. This one computes what the JAX package's live
// path computes (jax.ops.segment_sum/min/max over the jnp.where'd,
// widened column in _SegOps, hash_aggregate.py:211-242), with the mask
// and the widening read inside the kernel: the column comes in its own
// dtype (bool, int8-64, float32/64). Sums widen to wrapping int64 or to
// float64; min/max of bool, int8 and int16 widen to int32. A NaN makes
// its own segment's sum, min and max NaN, and only that segment's.
//
// Bound on the card: bytes. Each row is read once (4 B gid + the
// column's own width + 1 B mask) and costs one atomic; the output is k
// values. Hopper's limit here is the atomic rate, not HBM: one global
// atomic per row runs far below the byte bound when many rows hit few
// slots (0.062 ms for 4,194,304 rows into 16,384 float64 slots, 18% of
// the bound). So the accumulators live as close to the SM as they fit:
//
//   shared: each block keeps a private copy of all k accumulators in
//           its shared memory (up to 200 KiB: one 1024-thread block a
//           SM), folds its rows there, then folds each touched slot into
//           `acc` with one global atomic;
//   global: one global atomic per row into `acc`, for domains too big or
//           too sparse for a private copy.
// The shared blocks take their thread count at launch; the wrapper
// (ops/kernels/segreduce.py, `variant`) picks the variant by the copy's
// size and the rows per slot, from timings on the card (PERF.md, K3):
// fewer, wider blocks flush fewer copies.
//
// One encoding in which every empty accumulator is all-zero bits, so one
// cudaMemsetAsync clears `acc` and there is no init launch:
//   - sums: the value itself (float64 +0.0 or int64 0);
//   - max: key = ordered(x), folded with atomicMax;
//   - min: key = ~ordered(x), folded with atomicMax.
// ordered() maps int32/int64 to unsigned by flipping the sign bit, and
// float32/float64 by their bits: x >= +0 -> bits | sign, x < 0 -> ~bits,
// so keys order as the values with -0.0 below +0.0 (as XLA's min and
// max). A NaN, of any payload, is the all-ones key, which wins both.
// Every non-NaN float key lies strictly between 0 and all ones, and so
// the decode maps 0 to the empty segment's +-inf and all ones to NaN;
// for integers, key 0 decodes to INT_MAX (min) or INT_MIN (max), the
// empty segment's value, with no test. Hopper has no float atomic
// min/max; on these keys integer atomicMax does both.
//
// Decode: min/max keys become values in one more launch, which also
// gathers: out[i] = decode(acc[at[i]]) at the slots `at` (the occupied
// hash-table slots of the grouped aggregate, a gather it needs anyway),
// or out[i] = decode(acc[i]) over all k slots in place. It cannot fold
// into the reduction: a segment's key is final only after every block's
// atomics, and the kernel has no grid-wide barrier. Sums given `at` take
// the same launch as a plain gather.
//
// So a call is one cudaMemsetAsync, one reduction launch and, for
// min/max or a gather, one decode launch, all from one C entry.
// Float64 sums through atomics are not bit-repeatable from run to run.
//
// Plain C interface, loaded with ctypes. Launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // global variant and decode
constexpr int kMaxThreads = 1024;  // shared: set per launch
constexpr int kUnroll = 4;         // rows in flight per thread
constexpr int kMaxSharedBytes = 200 * 1024;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum Variant { kGlobal = 0, kShared = 1 };

// The width the column is reduced in: sums in int64 / float64, min/max
// of narrow integers in int32, of the rest in their own type.
template <typename S> struct Wide { typedef int32_t T; };
template <> struct Wide<int64_t> { typedef int64_t T; };
template <> struct Wide<float> { typedef float T; };
template <> struct Wide<double> { typedef double T; };

// bool columns arrive as bytes: any nonzero byte is 1
template <typename S> __device__ __forceinline__ S load(const S* p) {
  return *p;
}
template <> __device__ __forceinline__ uint8_t load(const uint8_t* p) {
  return *p != 0;
}

typedef unsigned int u32;
typedef unsigned long long u64;  // atomicMax/atomicAdd take this, not uint64_t

__device__ __forceinline__ u32 ordered(int32_t x) {
  return (u32)x ^ 0x80000000u;
}
__device__ __forceinline__ u64 ordered(int64_t x) {
  return (u64)x ^ 0x8000000000000000ull;
}
__device__ __forceinline__ u32 ordered(float x) {
  const u32 u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ u64 ordered(double x) {
  const u64 u = (u64)__double_as_longlong(x);
  return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
}
__device__ __forceinline__ void from_ordered(u32 k, int32_t* x) {
  *x = (int32_t)(k ^ 0x80000000u);
}
__device__ __forceinline__ void from_ordered(u64 k, int64_t* x) {
  *x = (int64_t)(k ^ 0x8000000000000000ull);
}
__device__ __forceinline__ void from_ordered(u32 k, float* x) {
  *x = __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}
__device__ __forceinline__ void from_ordered(u64 k, double* x) {
  *x = __longlong_as_double((long long)(
      (k & 0x8000000000000000ull) ? (k ^ 0x8000000000000000ull) : ~k));
}

template <typename T> struct KeyOf { typedef u32 K; };
template <> struct KeyOf<int64_t> { typedef u64 K; };
template <> struct KeyOf<double> { typedef u64 K; };

template <typename T> __device__ __forceinline__ bool is_nan(T) {
  return false;
}
template <> __device__ __forceinline__ bool is_nan(float x) { return x != x; }
template <> __device__ __forceinline__ bool is_nan(double x) { return x != x; }

// the empty segment's min (+inf) and a quiet NaN, by their bits
template <typename T> struct FloatBits;
template <> struct FloatBits<float> {
  __device__ static float inf() { return __int_as_float(0x7f800000); }
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
};
template <> struct FloatBits<double> {
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
};

template <typename S> struct IsFloat { static const bool value = false; };
template <> struct IsFloat<float> { static const bool value = true; };
template <> struct IsFloat<double> { static const bool value = true; };

// Accumulator of one (operation, column type): K the stored key, R the
// result type; enc() a row's key, fold() an atomic into shared or global
// memory, dec() a key back to a result.
template <int O, typename S, bool Float = IsFloat<S>::value> struct Acc {
  // min and max
  typedef typename Wide<S>::T R;
  typedef typename KeyOf<R>::K K;
  __device__ static K enc(S s) {
    const R x = (R)s;
    if (is_nan(x)) return ~K(0);
    return O == kMin ? ~ordered(x) : ordered(x);
  }
  __device__ static void fold(K* a, K x) { atomicMax(a, x); }
  __device__ static bool touched(K a) { return a != 0; }
  __device__ static R dec(K a) {
    if constexpr (Float) {
      if (a == 0) return O == kMin ? FloatBits<R>::inf() : -FloatBits<R>::inf();
      if (a == ~K(0)) return FloatBits<R>::nan();
    }
    R x;
    from_ordered(O == kMin ? K(~a) : a, &x);
    return x;
  }
};
template <typename S> struct Acc<kSum, S, true> {  // float sums
  typedef double K;
  typedef double R;
  __device__ static K enc(S x) { return (double)x; }
  __device__ static void fold(K* a, K x) { atomicAdd(a, x); }
  __device__ static bool touched(K a) { return __double_as_longlong(a) != 0; }
  __device__ static R dec(K a) { return a; }
};
template <typename S> struct Acc<kSum, S, false> {  // wrapping int sums
  typedef u64 K;
  typedef int64_t R;
  __device__ static K enc(S x) { return (K)(long long)x; }
  __device__ static void fold(K* a, K x) { atomicAdd(a, x); }
  __device__ static bool touched(K a) { return a != 0; }
  __device__ static R dec(K a) { return (R)a; }
};

// Fold every row of this block's share into fold(slot, key).
template <int O, typename S, typename F>
__device__ __forceinline__ void for_rows(const int32_t* __restrict__ gid,
                                         const S* __restrict__ v,
                                         const uint8_t* __restrict__ contrib,
                                         long long n, int k, F fold) {
  typedef Acc<O, S> A;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int g[kUnroll];
    S x[kUnroll];
    bool c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = i + u * stride;
      g[u] = gid[r];
      x[u] = load(v + r);
      c[u] = contrib == nullptr || contrib[r] != 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c[u] && (unsigned)g[u] < (unsigned)k) fold(g[u], A::enc(x[u]));
  }
  for (; i < n; i += stride) {
    const int g = gid[i];
    if ((contrib == nullptr || contrib[i] != 0) && (unsigned)g < (unsigned)k)
      fold(g, A::enc(load(v + i)));
  }
}

// Zero `count` keys of this block's shared memory.
template <typename K>
__device__ __forceinline__ void clear_shared(K* p, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) p[i] = K(0);
}

template <int O, typename S>
__global__ void __launch_bounds__(kThreads)
seg_global(const int32_t* __restrict__ gid, const S* __restrict__ v,
           const uint8_t* __restrict__ contrib, long long n, int k,
           typename Acc<O, S>::K* __restrict__ acc) {
  typedef Acc<O, S> A;
  for_rows<O, S>(gid, v, contrib, n, k,
                 [&](int g, typename A::K x) { A::fold(acc + g, x); });
}

template <int O, typename S>
__global__ void __launch_bounds__(kMaxThreads)
seg_shared(const int32_t* __restrict__ gid, const S* __restrict__ v,
           const uint8_t* __restrict__ contrib, long long n, int k,
           typename Acc<O, S>::K* __restrict__ acc) {
  typedef Acc<O, S> A;
  typedef typename A::K K;
  extern __shared__ __align__(16) unsigned char smem[];
  K* copy = reinterpret_cast<K*>(smem);
  clear_shared(copy, k);
  __syncthreads();
  for_rows<O, S>(gid, v, contrib, n, k,
                 [&](int g, K x) { A::fold(copy + g, x); });
  __syncthreads();
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    const K a = copy[s];
    if (A::touched(a)) A::fold(acc + s, a);
  }
}

// out[i] = dec(acc[at[i]]) for i < m, or dec(acc[i]) when at is null
// (then m == k, and out may be acc itself: same width, same index)
template <int O, typename S>
__global__ void __launch_bounds__(kThreads)
seg_decode(const typename Acc<O, S>::K* acc, int k,
           const int32_t* __restrict__ at, int m,
           typename Acc<O, S>::R* out) {
  typedef Acc<O, S> A;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += gridDim.x * blockDim.x) {
    const int s = at ? at[i] : i;
    out[i] = A::dec((unsigned)s < (unsigned)k ? acc[s]
                                              : typename A::K(0));
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
}

template <int O, typename S>
int run(const void* gid_, const void* v_, const void* contrib_, long long n,
        int k, void* acc_, const void* at, int m, void* out, int variant,
        int nblocks, int threads, cudaStream_t st) {
  typedef Acc<O, S> A;
  typedef typename A::K K;
  const int32_t* gid = (const int32_t*)gid_;
  const S* v = (const S*)v_;
  const uint8_t* contrib = (const uint8_t*)contrib_;
  K* acc = (K*)acc_;
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)k * sizeof(K), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    if (variant == kShared) {
      static const cudaError_t attr = allow_shared(seg_shared<O, S>);
      const size_t bytes = (size_t)k * sizeof(K);
      if (attr != cudaSuccess) return (int)attr;
      if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
      seg_shared<O, S><<<nblocks, threads, bytes, st>>>(gid, v, contrib, n,
                                                        k, acc);
    } else {
      seg_global<O, S><<<nblocks, kThreads, 0, st>>>(gid, v, contrib, n, k,
                                                     acc);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (O != kSum || at != nullptr) {
    const int mm = at ? m : k;
    int blocks = (mm + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks);
    seg_decode<O, S><<<blocks, kThreads, 0, st>>>(
        acc, k, (const int32_t*)at, mm,
        (typename A::R*)(at ? out : acc_));
    err = cudaGetLastError();
  }
  return (int)err;
}

// column dtype codes (ops/kernels/segreduce.py _SRC)
enum Src { kBool = 0, kI8, kI16, kI32, kI64, kF32, kF64 };

template <int O>
int by_src(int src, const void* gid, const void* v, const void* contrib,
           long long n, int k, void* acc, const void* at, int m, void* out,
           int variant, int nblocks, int threads, cudaStream_t st) {
#define BLAZE_SEG_RUN(T)                                                   \
  return run<O, T>(gid, v, contrib, n, k, acc, at, m, out, variant,       \
                   nblocks, threads, st)
  switch (src) {
    case kBool: BLAZE_SEG_RUN(uint8_t);
    case kI8: BLAZE_SEG_RUN(int8_t);
    case kI16: BLAZE_SEG_RUN(int16_t);
    case kI32: BLAZE_SEG_RUN(int32_t);
    case kI64: BLAZE_SEG_RUN(int64_t);
    case kF32: BLAZE_SEG_RUN(float);
    case kF64: BLAZE_SEG_RUN(double);
  }
#undef BLAZE_SEG_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// op: 0 sum, 1 min, 2 max; src: the column's dtype code; gid int32 (n,);
// v the column (n,); contrib uint8/bool (n,) or null; acc k keys of the
// result's width (cleared here); at int32 (m,) or null; out (m,) of the
// result type, or null when at is null (the result is then acc:
// decoded in place for min/max, the sums themselves for sums).
// variant: 0 global (256 threads a block), 1 shared (`threads` threads a
// block, at most 1024).
extern "C" int blaze_segment_reduce(int op, int src, const void* gid,
                                    const void* v, const void* contrib,
                                    long long n, int k, void* acc,
                                    const void* at, int m, void* out,
                                    int variant, int nblocks, int threads,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case kSum:
      return by_src<kSum>(src, gid, v, contrib, n, k, acc, at, m, out,
                          variant, nblocks, threads, st);
    case kMin:
      return by_src<kMin>(src, gid, v, contrib, n, k, acc, at, m, out,
                          variant, nblocks, threads, st);
    case kMax:
      return by_src<kMax>(src, gid, v, contrib, n, k, acc, at, m, out,
                          variant, nblocks, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
