// Segmented reduction: out[s] = sum / min / max of v[i] over the rows i
// with gid[i] == s, for s in [0, k). Rows whose gid lies outside [0, k)
// contribute nowhere. An empty segment holds the neutral element: 0 for
// sums, +inf / INT_MAX for min, -inf / INT_MIN for max.
//
// Replaces the TPU kernel blaze_tpu/ops/kernels/segreduce_pallas.py
// (`segment_sum` / `segment_minmax`, bodies `_sum_kernel` and
// `_minmax_kernel`). That kernel contracts a (rows x k) one-hot on the
// MXU, f32 only, k <= 8192. This one computes what the JAX package's live
// path computes (jax.ops.segment_sum/min/max in _SegOps,
// hash_aggregate.py:211-242): float64 and wrapping int64 sums; min/max of
// float32, float64, int32 and int64; domains from 1024 to 2^23 slots
// (raw hash-table slots). A NaN in a segment makes that segment's sum,
// min and max NaN, and only that segment's.
//
// Bound on the card: bytes. Each row is read once (4 B gid + the value)
// and costs one atomic; the output is k values. The design:
//   init:     one pass writes the (encoded) neutral element to out[0, k);
//   reduce:   either
//             (a) shared: each block keeps a private copy of all k
//                 accumulators in shared memory (k * 8 B <= 128 KiB),
//                 grid-strides over its rows with shared-memory atomics,
//                 then adds each touched slot to out with one global
//                 atomic - for domains small against the rows, where
//                 many rows hit each slot;
//             (b) global: every row does one global atomic on out - for
//                 large domains (up to 2^23 slots), where a private copy
//                 does not fit or would cost more to clear than to use;
//             the wrapper (ops/kernels/segreduce.py) picks by the copy's
//             size and the rows per segment, where each was faster;
//   decode:   float min/max only: ordered keys back to floats.
//
// Hopper has no float atomic min/max, so float min/max run on an ordered
// integer encoding: key = bits | sign-bit for x >= +0, ~bits for x < 0,
// which orders keys as the floats (-0.0 below +0.0, as XLA's min/max
// do). NaN is carried explicitly: it encodes to the key that wins (0 for
// min, all ones for max), and both decode back to a NaN. Float64 sums
// use atomicAdd(double), so their order, and their last bits, may vary
// from run to run. Integer sums add as unsigned 64-bit, which wraps
// without undefined behaviour.
//
// Plain C interface, loaded with ctypes. Each entry launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 128 * 1024;

enum class Op { Sum, Min, Max };

// Storage of one accumulator ("key") for each (value type, operation):
// enc/dec map values to keys; `neutral` is the empty segment's key;
// atomic() folds a key into an accumulator in shared or global memory.
template <typename T, Op O> struct Acc;

template <> struct Acc<double, Op::Sum> {
  typedef double K;
  __device__ static K neutral() { return 0.0; }
  __device__ static K enc(double x) { return x; }
  __device__ static double dec(K k) { return k; }
  __device__ static void atomic(K* a, K x) { atomicAdd(a, x); }
  __device__ static bool is_neutral(K k) { return __double_as_longlong(k) == 0; }
};

template <> struct Acc<int64_t, Op::Sum> {
  typedef unsigned long long K;
  __device__ static K neutral() { return 0ull; }
  __device__ static K enc(int64_t x) { return (K)x; }
  __device__ static int64_t dec(K k) { return (int64_t)k; }
  __device__ static void atomic(K* a, K x) { atomicAdd(a, x); }
  __device__ static bool is_neutral(K k) { return k == 0ull; }
};

// ordered 32-bit keys of float32
__device__ __forceinline__ unsigned int f32_key(float x) {
  const unsigned int u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float f32_from_key(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}
// ordered 64-bit keys of float64
__device__ __forceinline__ unsigned long long f64_key(double x) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(x);
  return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
}
__device__ __forceinline__ double f64_from_key(unsigned long long k) {
  return __longlong_as_double((long long)(
      (k & 0x8000000000000000ull) ? (k ^ 0x8000000000000000ull) : ~k));
}

template <> struct Acc<float, Op::Min> {
  typedef unsigned int K;
  __device__ static K neutral() { return f32_key(__int_as_float(0x7f800000)); }
  __device__ static K enc(float x) { return x != x ? 0u : f32_key(x); }
  __device__ static float dec(K k) { return f32_from_key(k); }
  __device__ static void atomic(K* a, K x) { atomicMin(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};
template <> struct Acc<float, Op::Max> {
  typedef unsigned int K;
  __device__ static K neutral() { return f32_key(-__int_as_float(0x7f800000)); }
  __device__ static K enc(float x) { return x != x ? 0xffffffffu : f32_key(x); }
  __device__ static float dec(K k) { return f32_from_key(k); }
  __device__ static void atomic(K* a, K x) { atomicMax(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};
template <> struct Acc<double, Op::Min> {
  typedef unsigned long long K;
  __device__ static K neutral() {
    return f64_key(__longlong_as_double(0x7ff0000000000000LL));
  }
  __device__ static K enc(double x) { return x != x ? 0ull : f64_key(x); }
  __device__ static double dec(K k) { return f64_from_key(k); }
  __device__ static void atomic(K* a, K x) { atomicMin(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};
template <> struct Acc<double, Op::Max> {
  typedef unsigned long long K;
  __device__ static K neutral() {
    return f64_key(-__longlong_as_double(0x7ff0000000000000LL));
  }
  __device__ static K enc(double x) { return x != x ? ~0ull : f64_key(x); }
  __device__ static double dec(K k) { return f64_from_key(k); }
  __device__ static void atomic(K* a, K x) { atomicMax(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};
template <> struct Acc<int32_t, Op::Min> {
  typedef int K;
  __device__ static K neutral() { return INT32_MAX; }
  __device__ static K enc(int32_t x) { return x; }
  __device__ static int32_t dec(K k) { return k; }
  __device__ static void atomic(K* a, K x) { atomicMin(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};
template <> struct Acc<int32_t, Op::Max> {
  typedef int K;
  __device__ static K neutral() { return INT32_MIN; }
  __device__ static K enc(int32_t x) { return x; }
  __device__ static int32_t dec(K k) { return k; }
  __device__ static void atomic(K* a, K x) { atomicMax(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};
template <> struct Acc<int64_t, Op::Min> {
  typedef long long K;
  __device__ static K neutral() { return INT64_MAX; }
  __device__ static K enc(int64_t x) { return (K)x; }
  __device__ static int64_t dec(K k) { return (int64_t)k; }
  __device__ static void atomic(K* a, K x) { atomicMin(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};
template <> struct Acc<int64_t, Op::Max> {
  typedef long long K;
  __device__ static K neutral() { return INT64_MIN; }
  __device__ static K enc(int64_t x) { return (K)x; }
  __device__ static int64_t dec(K k) { return (int64_t)k; }
  __device__ static void atomic(K* a, K x) { atomicMax(a, x); }
  __device__ static bool is_neutral(K k) { return k == neutral(); }
};

template <typename T, Op O>
__global__ void __launch_bounds__(kThreads)
seg_init(typename Acc<T, O>::K* __restrict__ out, int k) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x)
    out[i] = Acc<T, O>::neutral();
}

// (b) one global atomic per in-range row
template <typename T, Op O>
__global__ void __launch_bounds__(kThreads)
seg_global(const int32_t* __restrict__ gid, const T* __restrict__ v,
           long long n, int k, typename Acc<T, O>::K* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if ((unsigned)g < (unsigned)k) Acc<T, O>::atomic(out + g, Acc<T, O>::enc(v[i]));
  }
}

// (a) a private copy of the k accumulators per block in shared memory
template <typename T, Op O>
__global__ void __launch_bounds__(kThreads)
seg_shared(const int32_t* __restrict__ gid, const T* __restrict__ v,
           long long n, int k, typename Acc<T, O>::K* __restrict__ out) {
  typedef typename Acc<T, O>::K K;
  extern __shared__ unsigned char smem_raw[];
  K* acc = reinterpret_cast<K*>(smem_raw);
  for (int i = threadIdx.x; i < k; i += blockDim.x) acc[i] = Acc<T, O>::neutral();
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if ((unsigned)g < (unsigned)k) Acc<T, O>::atomic(acc + g, Acc<T, O>::enc(v[i]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const K a = acc[i];
    if (!Acc<T, O>::is_neutral(a)) Acc<T, O>::atomic(out + i, a);
  }
}

// keys back to values, in place (the key and the value have one width)
template <typename T, Op O>
__global__ void __launch_bounds__(kThreads)
seg_decode(typename Acc<T, O>::K* __restrict__ out, int k) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x) {
    const T x = Acc<T, O>::dec(out[i]);
    reinterpret_cast<T*>(out)[i] = x;
  }
}

template <typename T> struct NeedsDecode { static const bool value = false; };
template <> struct NeedsDecode<float> { static const bool value = true; };
template <> struct NeedsDecode<double> { static const bool value = true; };

template <typename T, Op O>
int launch(const void* gid, const void* v, long long n, int k, void* out,
           int nblocks, int shared, void* stream) {
  typedef typename Acc<T, O>::K K;
  static_assert(sizeof(K) == sizeof(T), "key and value widths differ");
  cudaStream_t st = (cudaStream_t)stream;
  K* acc = (K*)out;
  const int kblocks = (k + kThreads - 1) / kThreads < 4096
                          ? (k + kThreads - 1) / kThreads : 4096;
  seg_init<T, O><<<kblocks, kThreads, 0, st>>>(acc, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    if (shared) {
      const size_t bytes = (size_t)k * sizeof(K);
      static const cudaError_t attr = cudaFuncSetAttribute(
          seg_shared<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSharedBytes);
      if (attr != cudaSuccess) return (int)attr;
      if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
      seg_shared<T, O><<<nblocks, kThreads, bytes, st>>>(
          (const int32_t*)gid, (const T*)v, n, k, acc);
    } else {
      seg_global<T, O><<<nblocks, kThreads, 0, st>>>(
          (const int32_t*)gid, (const T*)v, n, k, acc);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (O != Op::Sum && NeedsDecode<T>::value) {
    seg_decode<T, O><<<kblocks, kThreads, 0, st>>>(acc, k);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

#define BLAZE_SEGREDUCE_ENTRY(NAME, T, O)                                  \
  extern "C" int NAME(const void* gid, const void* v, long long n, int k,  \
                      void* out, int nblocks, int shared, void* stream) {  \
    return launch<T, O>(gid, v, n, k, out, nblocks, shared, stream);      \
  }

BLAZE_SEGREDUCE_ENTRY(blaze_segment_sum_f64, double, Op::Sum)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_sum_i64, int64_t, Op::Sum)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_min_f32, float, Op::Min)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_min_f64, double, Op::Min)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_min_i32, int32_t, Op::Min)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_min_i64, int64_t, Op::Min)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_max_f32, float, Op::Max)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_max_f64, double, Op::Max)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_max_i32, int32_t, Op::Max)
BLAZE_SEGREDUCE_ENTRY(blaze_segment_max_i64, int64_t, Op::Max)
