"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 64 experts top-6.

48L d_model=2048 16H (kv=16) expert d_ff=1408, 64 routed top-6 + 2 shared,
vocab=163840.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="moonshot_v1_16b_a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,             # shared-expert path width (2 x 1408)
        vocab_size=163840,
        n_experts=64,
        top_k=6,
        moe_d_ff=1408,
        n_shared_experts=2,
        rope_theta=50000.0,
    )
)
