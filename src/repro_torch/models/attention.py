"""Attention of the dense family: causal GQA for prefill, and one-token
decode against a KV cache.

``causal_attention`` goes through the flash-attention kernel on the card
at every length; the reference switches to query-chunked jnp attention at
8192 tokens and above, which computes the same function.  Decode keeps the
cache at ``n_kv_heads`` and uses the grouped form (the logits are tiny at
one query), in plain PyTorch.  Windowed (RecurrentGemma) and cross
(Whisper) attention are ROADMAP Queue 1 #13.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.flash_attention.ops import flash_attention_bshd

NEG_INF = -2.0**30


def causal_attention(q, k, v, *, local_window: int = 0, use_kernel: bool = True):
    """q: [B,S,H,D]; k,v: [B,S,Hkv,D]. Returns [B,S,H,D]."""
    if local_window:
        raise NotImplementedError("windowed attention is not ported yet (ROADMAP Queue 1 #13)")
    return flash_attention_bshd(q, k, v, use_kernel=use_kernel)


def decode_attention(q1, k_cache, v_cache, pos):
    """One-token decode: q1 [B,1,H,D], caches [B,S,Hkv,D]; attends to cache
    positions <= pos.  Grouped form: logits are [B,Hkv,rep,1,S]."""
    b, s, hkv, d = k_cache.shape
    h = q1.shape[2]
    qg = q1.reshape(b, 1, hkv, h // hkv, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_cache).float() / np.sqrt(d)
    mask = torch.arange(s, device=q1.device) <= pos
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q1.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v_cache)
    return out.reshape(b, 1, h, d)
