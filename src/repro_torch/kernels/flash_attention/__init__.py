"""Causal flash attention: CUDA kernel, wrapper and plain version."""
