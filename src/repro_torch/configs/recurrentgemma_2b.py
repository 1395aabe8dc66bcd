"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: RG-LRU + local attn, 1:2.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
pattern (rglru, rglru, attn), local attention window 2048, d_rnn=2560.
Sub-quadratic => runs the long_500k shape.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="recurrentgemma_2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "attn"),
        local_window=2048,
        d_rnn=2560,
        conv_width=4,
        tie_embeddings=True,
        sub_quadratic=True,
        rope_theta=10000.0,
    )
)
