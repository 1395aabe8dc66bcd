"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed top-4 + shared.

24L d_model=2048 16H (kv=16) routed-expert d_ff=1408, 60 experts top-4,
4 shared experts (shared intermediate 4*1408=5632), vocab=151936.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2_moe_a27b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5632,             # shared-expert path width
        vocab_size=151936,
        qkv_bias=True,
        n_experts=60,
        top_k=4,
        moe_d_ff=1408,
        n_shared_experts=4,
        rope_theta=1000000.0,
    )
)
