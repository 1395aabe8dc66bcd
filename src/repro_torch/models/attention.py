"""Attention blocks: causal GQA for prefill, sliding-window local attention
(RecurrentGemma), cross-attention (Whisper), and one-token decode against a
KV cache.

``causal_attention`` goes through the flash-attention kernel on the card
at every length; the reference switches to query-chunked jnp attention at
8192 tokens and above, which computes the same function.  With a local
window W the reference's own rule picks the form: at S <= W the band mask
is vacuous, so it is causal attention and takes the kernel; at
W < S <= 2W the banded masked softmax and beyond 2W the block-local form,
both plain PyTorch, as the reference computes them in jnp (its TPU kernel
is causal only).  Cross attention and Whisper's non-causal encoder
self-attention are plain for the same reason.  Decode keeps the cache at
``n_kv_heads`` and uses the grouped form (the logits are tiny at one
query), in plain PyTorch.

Under a mesh (DTensor activations) the reference's hints place the head
axis over "model": q always, k and v at their ``n_kv_heads`` when that
divides the "model" axis and replicated otherwise, where the flash
wrapper hands each rank the KV heads its query heads read.  Where "model"
divides neither the heads nor the KV groups, the port gathers what it must
split (decode's query heads, the windowed output's block positions) where
XLA reshards the reference's arrays by itself.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.flash_attention.ops import flash_attention_bshd
from ..kernels.sharded import heads_local
from .common import batch_axes, is_dtensor, shard_hint, whole_over

NEG_INF = -2.0**30


def _expand_kv(k, n_heads: int):
    """[B,S,Hkv,D] -> [B,S,H,D]: query head h reads KV head h // (H / Hkv)."""
    hkv = k.shape[2]
    k = k if hkv == n_heads else k.repeat_interleave(n_heads // hkv, dim=2)
    return shard_hint(k, batch_axes(), None, "model", None)


def _heads_hint(t):
    """[B,S,H,D] with the batch over (pod, data) and the heads over "model"."""
    return shard_hint(t, batch_axes(), None, "model", None)


def causal_attention(q, k, v, *, local_window: int = 0, use_kernel: bool = True):
    """q: [B,S,H,D]; k,v: [B,S,Hkv,D]. Returns [B,S,H,D].  With
    ``local_window`` > 0 the mask is banded (sliding window)."""
    s = q.shape[1]
    if local_window and s > 2 * local_window:
        return _windowed_attention(q, k, v, local_window)
    if local_window and s > local_window:
        return _banded_attention(q, k, v, local_window)
    return flash_attention_bshd(_heads_hint(q), _heads_hint(k), _heads_hint(v), use_kernel=use_kernel)


def _banded_attention(q, k, v, window: int):
    """Causal attention with the sliding-window band, one masked softmax
    over the whole key axis (the reference's path for W < S <= 2W)."""
    b, s, h, d = q.shape
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", _heads_hint(q), k).float() * (1.0 / np.sqrt(d))
    logits = shard_hint(logits, batch_axes(), "model", "model", None)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _windowed_attention(q, k, v, window: int):
    """Block-local sliding-window attention: each query block of size W
    attends to its own and the previous key block => O(S*2W*D)."""
    b, s, h, d = q.shape
    w = window
    nb = (s + w - 1) // w
    pad = nb * w - s
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    q = _heads_hint(q)
    if pad:
        padding = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(a, padding) for a in (q, k, v))
    qb = q.reshape(b, nb, w, h, d)
    kb = k.reshape(b, nb, w, h, d)
    vb = v.reshape(b, nb, w, h, d)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1), kb], dim=2)  # [B,nb,2w,h,d]
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1), vb], dim=2)
    logits = torch.einsum("bnqhd,bnkhd->bnhqk", qb, k2).float() * (1.0 / np.sqrt(d))
    logits = shard_hint(logits, batch_axes(), None, "model", "model", None)
    qpos = torch.arange(w, device=q.device)[:, None] + w  # position on the 2w key axis
    kpos = torch.arange(2 * w, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - w)
    first_block = torch.arange(nb, device=q.device)[:, None, None] == 0
    valid = mask[None] & ~(first_block & (kpos[None] < w))  # [nb, w, 2w]
    logits = torch.where(valid[None, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, v2)
    # the query position in its block is gathered before it merges with the
    # block index into the sequence (it holds "model" where the heads do
    # not divide it, and a sharded inner dim would merge as a strided shard,
    # whose flatten in the output projection DTensor cannot propagate)
    out = shard_hint(out, batch_axes(), None, None, "model", None)
    return out.reshape(b, nb * w, h, d)[:, :s]


def cross_attention(q, k, v):
    """q: [B,Sq,H,D]; k,v: [B,Sk,Hkv,D]; full (non-causal) attention.  Under a
    mesh it is computed head-locally, on each rank's heads, by the rule of
    the flash wrapper (``kernels/sharded.py``)."""
    if is_dtensor(q):
        return heads_local("cross attention", cross_attention, _heads_hint(q), _heads_hint(k), _heads_hint(v))
    h, d = q.shape[2], q.shape[3]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / np.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(q1, k_cache, v_cache, pos, *, local_window: int = 0):
    """One-token decode: q1 [B,1,H,D], caches [B,S,Hkv,D]; attends to cache
    positions <= pos (banded if local).  Grouped form: logits are
    [B,Hkv,rep,1,S]."""
    b, s, hkv, d = k_cache.shape
    h = q1.shape[2]
    # under a mesh whose "model" does not divide the KV groups, q (one
    # token) is gathered over its heads; the cache keeps its placement
    qg = whole_over(q1, 2, hkv).reshape(b, 1, hkv, h // hkv, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_cache).float() / np.sqrt(d)
    kpos = torch.arange(s, device=q1.device)
    mask = kpos <= pos
    if local_window:
        mask = mask & (kpos > pos - local_window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q1.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v_cache)
    return out.reshape(b, 1, h, d)
