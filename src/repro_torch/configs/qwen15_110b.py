"""Qwen1.5-110B [hf:Qwen/Qwen1.5-110B family]: QKV bias, GQA.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen15_110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
    )
)
