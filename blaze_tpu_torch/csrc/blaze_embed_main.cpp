// Embedder-side test driver for the in-process C-ABI boundary.
//
// Plays the role of the reference's JVM consumer (FFIHelper.scala:
// 57-130): loads the engine IN PROCESS via libblaze_embed, executes a
// serialized TaskDefinition, walks each exported Arrow C-Data batch by
// raw pointer - no sockets, no IPC bytes, no copies - and prints
//   task <k>
//   rows <n>
//   col <i> sum <checksum>
// for each blob file it is given, in one embedded interpreter,
// which tests/test_torch_embed.py compares against the engine's own pyarrow
// answer (runtime/embed.run_task_checksums).
//
// The port's copy of cpp/blaze_embed_main.cpp. Build: see
// blaze_embed.cpp (blaze_tpu_torch/runtime/embed.py, build_host).

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "arrow_c_data.h"

extern "C" {
int blz_embed_init(const char* repo_path);
void* blz_embed_execute(const uint8_t* blob, int64_t len);
int blz_embed_next(void* handle, struct ArrowSchema* schema,
                   struct ArrowArray* array);
void blz_embed_close(void* handle);
const char* blz_embed_last_error(void);
void blz_embed_shutdown(void);
}

namespace {

bool bit_set(const uint8_t* bits, int64_t i) {
  return bits == nullptr || (bits[i >> 3] >> (i & 7)) & 1;
}

// Sum the valid values of one primitive column (spec formats:
// l=int64, i=int32, g=float64, f=float32, s=int16, c=int8, b=bool).
// Dictionary columns sum their CODES (the test's parity helper does
// the same); unknown formats contribute 0 and are reported.
double column_sum(const ArrowSchema* s, const ArrowArray* a) {
  const char* fmt = s->format;
  if (s->dictionary != nullptr) {
    // indices live in the main array; sum them
  }
  const uint8_t* validity =
      a->n_buffers > 0 ? static_cast<const uint8_t*>(a->buffers[0])
                       : nullptr;
  const void* data =
      a->n_buffers > 1 ? a->buffers[1] : nullptr;
  if (data == nullptr) return 0.0;
  double sum = 0.0;
  const int64_t off = a->offset;
  for (int64_t i = 0; i < a->length; i++) {
    if (!bit_set(validity, off + i)) continue;
    const int64_t j = off + i;
    switch (fmt[0]) {
      case 'l':
        sum += static_cast<double>(
            static_cast<const int64_t*>(data)[j]);
        break;
      case 'i':
        sum += static_cast<const int32_t*>(data)[j];
        break;
      case 'g':
        sum += static_cast<const double*>(data)[j];
        break;
      case 'f':
        sum += static_cast<const float*>(data)[j];
        break;
      case 's':
        sum += static_cast<const int16_t*>(data)[j];
        break;
      case 'c':
        sum += static_cast<const int8_t*>(data)[j];
        break;
      case 'b':
        sum += bit_set(static_cast<const uint8_t*>(data), j) ? 1 : 0;
        break;
      default:
        fprintf(stderr, "unhandled format %s\n", fmt);
    }
  }
  return sum;
}

// Runs one blob: prints its checksums, or its error on stderr. Returns
// 0, or 1 when the engine raised.
int run_blob(const char* path) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) {
    perror("open blob");
    return 2;
  }
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> blob(static_cast<size_t>(len));
  if (fread(blob.data(), 1, blob.size(), f) != blob.size()) {
    fprintf(stderr, "short read\n");
    fclose(f);
    return 2;
  }
  fclose(f);

  void* stream = blz_embed_execute(blob.data(),
                                   static_cast<int64_t>(blob.size()));
  if (stream == nullptr) {
    fprintf(stderr, "%s: execute failed: %s\n", path,
            blz_embed_last_error());
    return 1;
  }

  int64_t rows = 0;
  std::vector<double> sums;
  ArrowSchema schema;
  ArrowArray array;
  for (;;) {
    int got = blz_embed_next(stream, &schema, &array);
    if (got < 0) {
      fprintf(stderr, "%s: next failed: %s\n", path, blz_embed_last_error());
      blz_embed_close(stream);
      return 1;
    }
    if (got == 0) break;
    // top level is a struct array: one child per column
    rows += array.length;
    if (sums.empty()) sums.resize(static_cast<size_t>(array.n_children));
    for (int64_t c = 0; c < array.n_children; c++) {
      sums[static_cast<size_t>(c)] +=
          column_sum(schema.children[c], array.children[c]);
    }
    // consumer-side ownership: release both structs per the C-Data
    // contract once done with the pointers
    if (array.release != nullptr) array.release(&array);
    if (schema.release != nullptr) schema.release(&schema);
  }
  blz_embed_close(stream);

  printf("rows %" PRId64 "\n", rows);
  for (size_t c = 0; c < sums.size(); c++) {
    printf("col %zu sum %.6f\n", c, sums[c]);
  }
  return 0;
}

}  // namespace

// One interpreter for every blob on the command line: each blob's
// output starts with a `task <i>` line. Exits with the worst blob's code.
int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s REPO_PATH TASK_BLOB_FILE...\n", argv[0]);
    return 2;
  }
  if (blz_embed_init(argv[1]) != 0) {
    fprintf(stderr, "init failed: %s\n", blz_embed_last_error());
    return 1;
  }
  int status = 0;
  for (int i = 2; i < argc; i++) {
    printf("task %d\n", i - 2);
    int rc = run_blob(argv[i]);
    if (rc > status) status = rc;
  }
  blz_embed_shutdown();
  return status;
}
