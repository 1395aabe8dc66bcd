"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: mistral-nemo backbone + ViT.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=160.
The pixtral-ViT frontend is a STUB per assignment: input_specs() provides
precomputed patch embeddings [B, n_patches, d_model] prepended to the text.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="pixtral_12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=14336,
        vocab_size=131072,
        n_patches=256,
        rope_theta=1000000000.0,
    )
)
