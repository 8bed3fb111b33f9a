// Spark-compatible Murmur3 x86_32 of byte strings, chained into running
// per-row hashes: the host half of string hash partitioning.
//
// Bit-exact with org.apache.spark.unsafe.hash.Murmur3_x86_32
// .hashUnsafeBytes (seed chains across key columns, as Spark's
// HashExpression chains them): whole little-endian 4-byte words, then
// each tail byte sign-extended as a Java byte and sent through the full
// mixK1/mixH1 pipeline, then fmix with the byte length. A NULL row keeps
// its running hash; an empty string is fmix(seed, 0).
//
// Built with g++ into a shared library with a plain C interface and
// loaded with ctypes (blaze_tpu_torch/runtime/native.py):
//
//   g++ -O3 -shared -fPIC -std=c++17 -o libstrings_host-<hash>.so \
//       strings_host.cpp
//
// The pure-Python chain in exprs/hashing.py is its plain version.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

inline uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1b873593u;
  return k1;
}

inline uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xe6546b64u;
}

inline uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  h1 ^= h1 >> 16;
  return h1;
}

inline uint32_t hash_bytes(const uint8_t* data, int64_t len, uint32_t seed) {
  uint32_t h1 = seed;
  const int64_t aligned = len - (len % 4);
  for (int64_t i = 0; i < aligned; i += 4) {
    uint32_t word;
    std::memcpy(&word, data + i, 4);  // little-endian host
    h1 = mix_h1(h1, mix_k1(word));
  }
  for (int64_t i = aligned; i < len; i++) {
    const int32_t b = static_cast<int8_t>(data[i]);  // a Java byte
    h1 = mix_h1(h1, mix_k1(static_cast<uint32_t>(b)));
  }
  return fmix(h1, static_cast<uint32_t>(len));
}

}  // namespace

extern "C" {

// Chain an Arrow string column (int32 offsets, n + 1 entries) into the
// running hashes. validity is a byte mask (1 = valid) or null.
void blz_murmur3_strings_chain(const uint8_t* data, const int32_t* offsets,
                               const uint8_t* validity, int64_t n,
                               uint32_t* hashes) {
  for (int64_t i = 0; i < n; i++) {
    if (validity && !validity[i]) continue;
    hashes[i] = hash_bytes(data + offsets[i], offsets[i + 1] - offsets[i],
                           hashes[i]);
  }
}

// Chain a dictionary-encoded column: row i hashes dictionary entry
// codes[i] with its own running seed. Returns the number of valid rows
// whose code is outside [0, n_dict) (left unhashed); the caller raises.
int64_t blz_murmur3_dict_strings_chain(const uint8_t* dict_data,
                                       const int32_t* dict_offsets,
                                       int64_t n_dict, const int32_t* codes,
                                       const uint8_t* validity, int64_t n,
                                       uint32_t* hashes) {
  int64_t bad = 0;
  for (int64_t i = 0; i < n; i++) {
    if (validity && !validity[i]) continue;
    const int32_t c = codes[i];
    if (c < 0 || c >= n_dict) {
      bad++;
      continue;
    }
    hashes[i] = hash_bytes(dict_data + dict_offsets[c],
                           dict_offsets[c + 1] - dict_offsets[c], hashes[i]);
  }
  return bad;
}

}  // extern "C"
