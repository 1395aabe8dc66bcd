"""Segmented batched block GEMM: CUDA kernel, wrapper and plain version."""
