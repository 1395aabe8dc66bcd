"""Whisper-tiny [arXiv:2212.04356]: encoder-decoder, conv frontend stubbed.

4 encoder + 4 decoder layers, d_model=384 6H d_ff=1536 vocab=51865.
input_specs() provides precomputed frame embeddings [B, 1500, 384] (the
conv1d+GELU frontend output), per the assignment's modality-stub rule.
Full attention (quadratic) => long_500k skipped.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="whisper_tiny",
        family="audio",
        n_layers=4,            # decoder layers
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        enc_seq_len=1500,
        tie_embeddings=True,
        rope_theta=0.0,        # whisper uses learned/sinusoidal positions
    )
)
