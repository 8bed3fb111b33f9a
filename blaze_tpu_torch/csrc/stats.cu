// Masked column statistics: (sum, min, max, count) over rows whose mask
// byte is non-zero, in one pass over the column.
//
// Replaces the TPU kernel blaze_tpu/ops/kernels/stats_pallas.py
// (`masked_stats`, body `_kernel`). Unlike that kernel it does not keep
// f32 partials: the sum accumulates in the aggregate's state type
// (double for float input, two's-complement int64 for integer input),
// matching the JAX package's live keyless-aggregate path.
//
// Bound on the card: bytes. Each row is read once (value + 1 mask byte)
// and costs four compares/adds, far below the ALU rate, so the least
// time is (value bytes + mask bytes) / HBM bandwidth. The design:
//   launch 1: every thread grid-strides over the column keeping all four
//             states in registers; the block folds them with warp
//             shuffles and then through shared memory, and writes one
//             partial per block to scratch;
//   launch 2: one block folds the partials in a fixed order.
// No float atomics: the fold order depends only on the column length,
// so results repeat bit for bit from run to run.
//
// NaN propagates through min and max (jnp.min / jnp.max semantics);
// fminf/fmaxf would drop it, so they are not used. Integer sums add as
// unsigned 64-bit, which wraps without undefined behaviour.
//
// Plain C interface, loaded with ctypes. Each entry launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalThreads = 256;

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float lo() { return -__int_as_float(0x7f800000); }  // -inf
  __device__ static float hi() { return __int_as_float(0x7f800000); }  // +inf
};
template <> struct Lim<double> {
  __device__ static double lo() { return -__longlong_as_double(0x7ff0000000000000LL); }
  __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000LL); }
};
template <> struct Lim<int32_t> {
  __device__ static int32_t lo() { return INT32_MIN; }
  __device__ static int32_t hi() { return INT32_MAX; }
};
template <> struct Lim<int64_t> {
  __device__ static int64_t lo() { return INT64_MIN; }
  __device__ static int64_t hi() { return INT64_MAX; }
};

// NaN-propagating min/max (a NaN operand wins), with -0.0 below +0.0
// whatever the order of the rows (as jnp.min / jnp.max); for integers
// the NaN and sign tests fold away.
template <typename T> __device__ __forceinline__ bool neg_bit(T) { return false; }
__device__ __forceinline__ bool neg_bit(float x) { return signbit(x); }
__device__ __forceinline__ bool neg_bit(double x) { return signbit(x); }
template <typename T> __device__ __forceinline__ T min_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return (b < a || (b == a && neg_bit(b))) ? b : a;
}
template <typename T> __device__ __forceinline__ T max_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return (b > a || (b == a && !neg_bit(b))) ? b : a;
}

// Sum state: double for floats, unsigned 64-bit (wrapping) for ints.
template <typename T> struct Acc { typedef double type; };
template <> struct Acc<int32_t> { typedef unsigned long long type; };
template <> struct Acc<int64_t> { typedef unsigned long long type; };

__device__ __forceinline__ double widen(float x) { return (double)x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ unsigned long long widen(int32_t x) {
  return (unsigned long long)(long long)x;
}
__device__ __forceinline__ unsigned long long widen(int64_t x) {
  return (unsigned long long)x;
}

template <typename T> struct State {
  typename Acc<T>::type sum;
  T lo;
  T hi;
  unsigned long long cnt;
};

template <typename T> __device__ __forceinline__ State<T> neutral() {
  State<T> s;
  s.sum = 0;
  s.lo = Lim<T>::hi();
  s.hi = Lim<T>::lo();
  s.cnt = 0;
  return s;
}

template <typename T>
__device__ __forceinline__ void fold(State<T>& a, const State<T>& b) {
  a.sum += b.sum;
  a.lo = min_nan(a.lo, b.lo);
  a.hi = max_nan(a.hi, b.hi);
  a.cnt += b.cnt;
}

// Fold the block's states into thread 0's, in a fixed order.
template <typename T>
__device__ __forceinline__ State<T> block_fold(State<T> s) {
  __shared__ State<T> warp_states[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    State<T> o;
    o.sum = __shfl_down_sync(0xffffffffu, s.sum, off);
    o.lo = __shfl_down_sync(0xffffffffu, s.lo, off);
    o.hi = __shfl_down_sync(0xffffffffu, s.hi, off);
    o.cnt = __shfl_down_sync(0xffffffffu, s.cnt, off);
    fold(s, o);
  }
  if (lane == 0) warp_states[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s = lane < nwarps ? warp_states[lane] : neutral<T>();
    for (int off = 16; off > 0; off >>= 1) {
      State<T> o;
      o.sum = __shfl_down_sync(0xffffffffu, s.sum, off);
      o.lo = __shfl_down_sync(0xffffffffu, s.lo, off);
      o.hi = __shfl_down_sync(0xffffffffu, s.hi, off);
      o.cnt = __shfl_down_sync(0xffffffffu, s.cnt, off);
      fold(s, o);
    }
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_partial(const T* __restrict__ v, const uint8_t* __restrict__ m,
              long long n, typename Acc<T>::type* __restrict__ psum,
              T* __restrict__ plo, T* __restrict__ phi,
              unsigned long long* __restrict__ pcnt) {
  State<T> s = neutral<T>();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (m[i]) {
      const T x = v[i];
      s.sum += widen(x);
      s.lo = min_nan(s.lo, x);
      s.hi = max_nan(s.hi, x);
      s.cnt += 1;
    }
  }
  s = block_fold(s);
  if (threadIdx.x == 0) {
    psum[blockIdx.x] = s.sum;
    plo[blockIdx.x] = s.lo;
    phi[blockIdx.x] = s.hi;
    pcnt[blockIdx.x] = s.cnt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
stats_final(const typename Acc<T>::type* __restrict__ psum,
            const T* __restrict__ plo, const T* __restrict__ phi,
            const unsigned long long* __restrict__ pcnt, int nparts,
            typename Acc<T>::type* __restrict__ osum, T* __restrict__ olo,
            T* __restrict__ ohi, unsigned long long* __restrict__ ocnt) {
  State<T> s = neutral<T>();
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    State<T> p;
    p.sum = psum[i];
    p.lo = plo[i];
    p.hi = phi[i];
    p.cnt = pcnt[i];
    fold(s, p);
  }
  s = block_fold(s);
  if (threadIdx.x == 0) {
    *osum = s.sum;
    *olo = s.lo;
    *ohi = s.hi;
    *ocnt = s.cnt;
  }
}

template <typename T>
int launch(const void* v, const void* m, long long n, int nblocks,
           void* psum, void* plo, void* phi, void* pcnt, void* osum,
           void* olo, void* ohi, void* ocnt, void* stream) {
  typedef typename Acc<T>::type A;
  cudaStream_t st = (cudaStream_t)stream;
  stats_partial<T><<<nblocks, kThreads, 0, st>>>(
      (const T*)v, (const uint8_t*)m, n, (A*)psum, (T*)plo, (T*)phi,
      (unsigned long long*)pcnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_final<T><<<1, kFinalThreads, 0, st>>>(
      (const A*)psum, (const T*)plo, (const T*)phi,
      (const unsigned long long*)pcnt, nblocks, (A*)osum, (T*)olo, (T*)ohi,
      (unsigned long long*)ocnt);
  return (int)cudaGetLastError();
}

}  // namespace

#define BLAZE_STATS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* v, const void* m, long long n,          \
                      int nblocks, void* psum, void* plo, void* phi,      \
                      void* pcnt, void* osum, void* olo, void* ohi,       \
                      void* ocnt, void* stream) {                         \
    return launch<T>(v, m, n, nblocks, psum, plo, phi, pcnt, osum, olo,   \
                     ohi, ocnt, stream);                                  \
  }

BLAZE_STATS_ENTRY(blaze_masked_stats_f32, float)
BLAZE_STATS_ENTRY(blaze_masked_stats_f64, double)
BLAZE_STATS_ENTRY(blaze_masked_stats_i32, int32_t)
BLAZE_STATS_ENTRY(blaze_masked_stats_i64, int64_t)
