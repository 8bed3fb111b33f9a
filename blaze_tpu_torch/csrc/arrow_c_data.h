// Arrow C data interface struct definitions.
//
// These two structs are the Arrow project's STABLE C ABI, published
// specifically so that independent implementations re-declare them
// verbatim (https://arrow.apache.org/docs/format/CDataInterface.html).
// The reference consumes the same ABI from the JVM side
// (FFIHelper.scala:57-130); our producer is pyarrow's _export_to_c.

#pragma once
#include <cstdint>

#define ARROW_FLAG_DICTIONARY_ORDERED 1
#define ARROW_FLAG_NULLABLE 2
#define ARROW_FLAG_MAP_KEYS_SORTED 4

extern "C" {

struct ArrowSchema {
  const char* format;
  const char* name;
  const char* metadata;
  int64_t flags;
  int64_t n_children;
  struct ArrowSchema** children;
  struct ArrowSchema* dictionary;
  void (*release)(struct ArrowSchema*);
  void* private_data;
};

struct ArrowArray {
  int64_t length;
  int64_t null_count;
  int64_t offset;
  int64_t n_buffers;
  int64_t n_children;
  const void** buffers;
  struct ArrowArray** children;
  struct ArrowArray* dictionary;
  void (*release)(struct ArrowArray*);
  void* private_data;
};

}  // extern "C"
