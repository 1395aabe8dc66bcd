"""Architecture config schema and registry of the port's LM scaffold.

The schema, the ten architectures and ``smoke()`` are the reference's field
for field, so every config compares equal to the reference's.  Each
architecture has one ``configs/<id>.py`` exporting ``CONFIG``; the registry
resolves ``--arch <id>``.  ``smoke()`` derives the reduced same-family
config of the CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

ARCH_IDS = [
    "rwkv6_3b",
    "codeqwen15_7b",
    "qwen15_110b",
    "llama3_8b",
    "granite_3_2b",
    "pixtral_12b",
    "whisper_tiny",
    "qwen2_moe_a27b",
    "moonshot_v1_16b_a3b",
    "recurrentgemma_2b",
]

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
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "attn")
    local_window: int = 0
    d_rnn: int = 0                        # RG-LRU recurrent width
    conv_width: int = 4
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq_len: int = 0                  # stub frontend output length
    # --- vlm (pixtral) ---
    n_patches: int = 0                    # stub patch embeddings per image
    # --- capability flags ---
    sub_quadratic: bool = False           # eligible for long_500k
    has_decoder: bool = True              # encoder-only archs skip decode
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""              # "" = model dtype; "int8" quantizes

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included once)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.family == "ssm":  # rwkv6 time-mix ~ 5 square mats + loras
            attn = 5 * d * d
        ffn = 3 * d * self.d_ff
        if self.n_experts:
            ffn = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            if self.n_shared_experts:
                ffn += 3 * d * self.moe_d_ff * self.n_shared_experts
        per_layer = attn + ffn
        if self.block_pattern:
            n_attn = sum(1 for _ in range(L) if self._layer_kind(_) == "attn")
            n_rec = L - n_attn
            rec = 3 * d * self.d_rnn + self.d_rnn * self.conv_width + 2 * self.d_rnn
            per = n_attn * (attn + ffn) + n_rec * (rec + ffn)
            return per + 2 * self.vocab_size * d
        total = L * per_layer + self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.n_enc_layers:
            total += self.n_enc_layers * per_layer + L * (attn + d * d)  # cross-attn
        return total

    def active_param_count(self) -> int:
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        ffn = (self.top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff + d * self.n_experts
        return L * (attn + ffn) + self.vocab_size * d * 2

    def _layer_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self._layer_kind(i) for i in range(self.n_layers))

    def shape_supported(self, shape_name: str) -> Tuple[bool, str]:
        kind = SHAPES[shape_name]["kind"]
        if kind == "decode" and not self.has_decoder:
            return False, "encoder-only arch has no decode step"
        if shape_name == "long_500k" and not self.sub_quadratic:
            return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
        return True, ""

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
            capacity_factor=8.0,  # dropless at test sizes
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
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]

