// Flash attention's kernels at head dim 32: every variant and tile the
// library has there (flash_attention.cuh), in a translation unit of its own
// so that nvcc compiles the head dims in parallel.
#include "flash_attention.cuh"

FLASH_ATTENTION_PART(32)
