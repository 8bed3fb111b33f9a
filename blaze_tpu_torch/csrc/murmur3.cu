// Spark murmur3 partition ids: for each row of a batch, Spark's
// Murmur3Hash (Murmur3_x86_32, seed 42) chained over the key columns,
// then pmod(hash, n). Rows at or past num_rows (the batch's padding)
// get the sentinel n, so one stable sort by id leaves them last.
//
// Replaces the TPU kernel blaze_tpu/ops/kernels/murmur3_pallas.py
// (`partition_ids_int32`, body `_kernel_int32`; `partition_ids_int64`,
// body `_kernel_int64`). That kernel hashes one non-null int32 or int64
// key with n fixed at compile time; the JAX package computes every other
// key list outside Pallas (exprs/hashing.hash_columns_device). This one
// kernel covers the whole chain, with n at run time:
//   bool, int8, int16, int32 (and date32)  hashInt of the sign-extended
//                                          int (bool: 0 or 1)
//   int64 (timestamp_us, decimal <= 18)   hashLong, low word then high
//   float32                               hashInt(floatToIntBits):
//                                         -0.0 -> 0, NaN -> 0x7fc00000
//   float64                               hashLong(doubleToLongBits):
//                                         -0.0 -> 0, NaN -> 0x7ff8...0
// A NULL (validity byte 0) leaves the running hash unchanged. Subnormals
// hash by their own bits: nvcc does not flush them without -ftz.
//
// Bound on the card: bytes. A row reads each key column once (1 to 8
// bytes, plus a validity byte where the column has one) and writes one
// 4-byte id; the mixing is some 20 integer operations a column, far
// below the integer rate. One thread per row in a grid-stride loop,
// uint32 arithmetic throughout, so every shift is logical; neighbouring
// threads read neighbouring rows, so the loads coalesce.
//
// More than kMaxCols key columns run as several launches: a launch may
// start from the running hashes of the one before (h_in) and, when it
// is not the last, writes those hashes instead of ids (emit_hash).
//
// Plain C interface, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 8;
constexpr int kThreads = 256;

enum Kind : int { kBool = 0, kI8, kI16, kI32, kI64, kF32, kF64 };

struct KeyCols {
  const void* values[kMaxCols];
  const uint8_t* valid[kMaxCols];  // nullptr: no NULLs
  int kind[kMaxCols];
  int ncols;
};

constexpr uint32_t kSeed = 42u;
constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kM5 = 0xe6546b64u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k) {
  return rotl(k * kC1, 15) * kC2;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h, uint32_t k) {
  return rotl(h ^ k, 13) * 5u + kM5;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h, uint32_t len) {
  h ^= len;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t seed) {
  return fmix(mix_h1(seed, mix_k1(v)), 4u);
}

__device__ __forceinline__ uint32_t hash_long(uint64_t v, uint32_t seed) {
  uint32_t h = mix_h1(seed, mix_k1((uint32_t)v));
  h = mix_h1(h, mix_k1((uint32_t)(v >> 32)));
  return fmix(h, 8u);
}

__device__ __forceinline__ uint32_t hash_value(int kind, const void* p,
                                               long long i, uint32_t h) {
  switch (kind) {
    case kBool:
      return hash_int(((const uint8_t*)p)[i] != 0, h);
    case kI8:
      return hash_int((uint32_t)(int32_t)((const int8_t*)p)[i], h);
    case kI16:
      return hash_int((uint32_t)(int32_t)((const int16_t*)p)[i], h);
    case kI32:
      return hash_int((uint32_t)((const int32_t*)p)[i], h);
    case kI64:
      return hash_long((uint64_t)((const int64_t*)p)[i], h);
    case kF32: {
      const float f = ((const float*)p)[i];
      const uint32_t bits = f == 0.0f ? 0u
                            : f != f  ? 0x7fc00000u
                                      : __float_as_uint(f);
      return hash_int(bits, h);
    }
    default: {  // kF64
      const double d = ((const double*)p)[i];
      const uint64_t bits = d == 0.0 ? 0ull
                            : d != d  ? 0x7ff8000000000000ull
                                      : (uint64_t)__double_as_longlong(d);
      return hash_long(bits, h);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
partition_ids(KeyCols cols, const uint32_t* __restrict__ h_in,
              long long num_rows, long long capacity, int n, int emit_hash,
              int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < capacity; i += stride) {
    if (i >= num_rows) {
      out[i] = n;
      continue;
    }
    uint32_t h = h_in != nullptr ? h_in[i] : kSeed;
    for (int c = 0; c < cols.ncols; ++c) {
      if (cols.valid[c] != nullptr && cols.valid[c][i] == 0) continue;
      h = hash_value(cols.kind[c], cols.values[c], i, h);
    }
    if (emit_hash) {
      out[i] = (int32_t)h;
    } else {
      // Java's % truncates toward zero, as C++'s does: pmod adds n to a
      // negative remainder
      const int32_t r = (int32_t)h % n;
      out[i] = r < 0 ? r + n : r;
    }
  }
}

}  // namespace

extern "C" int blaze_murmur3_partition_ids(
    const long long* values, const long long* valid, const int* kinds,
    int ncols, const void* h_in, long long num_rows, long long capacity,
    int n, int emit_hash, void* out, int nblocks, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || n < 1) return (int)cudaErrorInvalidValue;
  KeyCols cols = {};
  for (int c = 0; c < ncols; ++c) {
    cols.values[c] = (const void*)values[c];
    cols.valid[c] = (const uint8_t*)valid[c];
    cols.kind[c] = kinds[c];
  }
  cols.ncols = ncols;
  partition_ids<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      cols, (const uint32_t*)h_in, num_rows, capacity, n, emit_hash,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
