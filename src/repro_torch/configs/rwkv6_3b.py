"""RWKV6 (Finch) 3B — attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=2560 d_ff=8960 vocab=65536; head_size 64 => 40 time-mix heads.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="rwkv6_3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,          # time-mix heads = d_model / rwkv_head_dim
        n_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        rwkv_head_dim=64,
        sub_quadratic=True,
    )
)
