"""Hand-written CUDA kernels for Hopper, one module per TPU kernel they
replace: `stats` (K1, masked statistics), `compact` (K2, compaction
permutation), `segreduce` (K3, segmented reduce) and `murmur3` (K4,
Spark murmur3 partition ids). Each module holds the wrapper, a plain
PyTorch version of the same function, and a launch counter; `_build`
compiles and loads the sources in `csrc/`."""
