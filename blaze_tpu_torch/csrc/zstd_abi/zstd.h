// The part of zstd's public API that cpp/blaze_client.cpp calls, for a
// host that has the shared library (libzstd.so.1) but not its
// development header: declarations as zstd 1.x's zstd.h states them,
// stable across its 1.x releases. chip_smoke.py's build_client compiles
// the client against this directory and links -l:libzstd.so.1 when
// <zstd.h> cannot be found.
#ifndef BLAZE_ZSTD_ABI_H
#define BLAZE_ZSTD_ABI_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)

unsigned long long ZSTD_getFrameContentSize(const void* src,
                                            size_t srcSize);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);
const char* ZSTD_getErrorName(size_t code);

#ifdef __cplusplus
}
#endif

#endif  // BLAZE_ZSTD_ABI_H
