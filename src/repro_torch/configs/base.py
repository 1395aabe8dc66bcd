"""Architecture config schema and registry of the port's LM slice.

The schema is the reference's field for field, so a config compares equal
to the reference's.  Only the architectures the port runs are registered:
``llama3_8b`` (dense GQA) and ``rwkv6_3b`` (RWKV6).  The other assigned
architectures (MoE, RG-LRU hybrid, VLM, Whisper) are ROADMAP Queue 1 #13.
``smoke()`` derives the reduced same-family config of the CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

ARCH_IDS = ["llama3_8b", "rwkv6_3b"]

# canonical input shapes for LM-family archs (seq_len, global_batch)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (recurrentgemma): layer pattern, repeated; local attn window
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 0
    d_rnn: int = 0
    conv_width: int = 4
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq_len: int = 0
    # --- vlm (pixtral) ---
    n_patches: int = 0
    # --- capability flags ---
    sub_quadratic: bool = False
    has_decoder: bool = True
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""              # "" = model dtype; "int8" quantizes

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        pat = self.block_pattern
        n_layers = len(pat) if pat else 2
        return dataclasses.replace(
            self,
            n_layers=max(n_layers, 2 if not pat else len(pat)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 // max(1, self.n_rep)),
            head_dim=16,
            d_ff=96,
            vocab_size=128,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=32 if self.n_experts else 0,
            capacity_factor=8.0,
            n_shared_experts=min(self.n_shared_experts, 1),
            d_rnn=64 if self.d_rnn else 0,
            local_window=16 if self.local_window else 0,
            rwkv_head_dim=16,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_seq_len=24 if self.enc_seq_len else 0,
            n_patches=8 if self.n_patches else 0,
            dtype="float32",
        )


_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "")
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet; the port runs {ARCH_IDS} "
            "(the other LM families are ROADMAP Queue 1 #13)"
        )
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]
