"""Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base]: GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155, tied embeddings.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="granite_3_2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=49155,
        tie_embeddings=True,
        rope_theta=10000.0,
    )
)
