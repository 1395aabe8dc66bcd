"""Chunked RWKV6 WKV scan: CUDA kernel, wrapper and plain version."""
