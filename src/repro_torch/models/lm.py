"""Decoder-only LM assembly of the port: dense GQA (llama3) and RWKV6 (ssm),
prefill and cached one-token decode.

Parameters are a flat dict path -> tensor in the reference's layout: the
layers' parameters are stacked along a leading ``n_layers`` axis under
``blocks/L0/`` and the forward loops over layers in Python, taking a view
of each.  This is inference only, so the reference's rematerialisation has
no counterpart.  MoE, RG-LRU hybrids, VLM patch inputs, the int8 KV cache
and windowed attention are ROADMAP Queue 1 #13 and raise here.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import rwkv6 as rk
from .attention import causal_attention, decode_attention
from .common import Registry, dtype_of, layer_norm, rms_norm, rope, sub, swiglu

VOCAB_PAD = 512
FAMILIES = ("dense", "ssm")


def padded_vocab(cfg) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _check_ported(cfg):
    if cfg.family not in FAMILIES or cfg.n_experts or cfg.block_pattern or cfg.local_window:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (MoE, RG-LRU, VLM, Whisper, windowed attention) "
            "is not ported yet (ROADMAP Queue 1 #13)"
        )
    if cfg.kv_cache_dtype:
        raise NotImplementedError("the int8 KV cache is not ported yet (ROADMAP Queue 1 #13)")


def _kind(cfg) -> str:
    return "rwkv" if cfg.family == "ssm" else "attn"


def _layers(params: Dict, cfg):
    """Per-layer parameter views of the stacked ``blocks/L0/...`` tensors."""
    stacked = sub(params, "blocks/L0")
    for i in range(cfg.n_layers):
        yield i, {k: v[i] for k, v in stacked.items()}


# --------------------------------------------------------------------- init
def _attn_params(reg: Registry, prefix: str, cfg, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    reg.add(f"{prefix}/wq", (d, cfg.n_heads * hd), dtype=dtype)
    reg.add(f"{prefix}/wk", (d, cfg.n_kv_heads * hd), dtype=dtype)
    reg.add(f"{prefix}/wv", (d, cfg.n_kv_heads * hd), dtype=dtype)
    reg.add(f"{prefix}/wo", (cfg.n_heads * hd, d), dtype=dtype)
    if cfg.qkv_bias:
        reg.add(f"{prefix}/bq", (cfg.n_heads * hd,), zeros=True, dtype=dtype)
        reg.add(f"{prefix}/bk", (cfg.n_kv_heads * hd,), zeros=True, dtype=dtype)
        reg.add(f"{prefix}/bv", (cfg.n_kv_heads * hd,), zeros=True, dtype=dtype)


def _layer_params(reg: Registry, prefix: str, cfg, dtype):
    d = cfg.d_model
    if _kind(cfg) == "attn":
        reg.add(f"{prefix}/ln1", (d,), zeros=True, dtype=dtype)
        _attn_params(reg, f"{prefix}/attn", cfg, dtype)
        reg.add(f"{prefix}/ln2", (d,), zeros=True, dtype=dtype)
        reg.add(f"{prefix}/ffn/w_gate", (d, cfg.d_ff), dtype=dtype)
        reg.add(f"{prefix}/ffn/w_up", (d, cfg.d_ff), dtype=dtype)
        reg.add(f"{prefix}/ffn/w_down", (cfg.d_ff, d), dtype=dtype)
    else:
        for ln in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            reg.add(f"{prefix}/{ln}", (d,), zeros=True, dtype=dtype)
        rk.time_mix_params(reg, f"{prefix}/tm", d, cfg.n_heads, cfg.rwkv_head_dim, dtype=dtype)
        rk.channel_mix_params(reg, f"{prefix}/cm", d, cfg.d_ff, dtype=dtype)


def init_lm(cfg, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    """Random parameters at the reference's scales, drawn on ``device`` from
    ``generator`` (which must live on the same device)."""
    _check_ported(cfg)
    dtype = dtype_of(cfg)
    reg = Registry(generator, device)
    d, v = cfg.d_model, padded_vocab(cfg)
    reg.add("embed", (v, d), scale=0.02, dtype=dtype)
    if cfg.family == "ssm":
        reg.add("ln0_g", (d,), zeros=True, dtype=dtype)
        reg.add("ln0_b", (d,), zeros=True, dtype=dtype)
    blocks = Registry(generator, device, layers=cfg.n_layers)
    _layer_params(blocks, "blocks/L0", cfg, dtype)
    reg.params.update(blocks.params)
    reg.add("ln_f", (d,), zeros=True, dtype=dtype)
    if not cfg.tie_embeddings:
        reg.add("lm_head", (d, v), scale=0.02, dtype=dtype)
    return reg.params


# ------------------------------------------------------------------- apply
def _attn_apply(lp: Dict, x, cfg, positions, use_kernel: bool):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = rope(q.reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    o = causal_attention(q, k, v, use_kernel=use_kernel)
    return o.reshape(b, s, cfg.n_heads * hd) @ lp["wo"]


def _apply_layer(lp: Dict, x, cfg, positions, use_kernel: bool):
    if _kind(cfg) == "attn":
        x = x + _attn_apply(sub(lp, "attn"), rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, positions, use_kernel)
        f = sub(lp, "ffn")
        return x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), f["w_gate"], f["w_up"], f["w_down"])
    t, _ = rk.time_mix(sub(lp, "tm"), layer_norm(x, 1.0 + lp["ln1_g"], lp["ln1_b"]),
                       cfg.n_heads, cfg.rwkv_head_dim, use_kernel=use_kernel)
    x = x + t
    c, _ = rk.channel_mix(sub(lp, "cm"), layer_norm(x, 1.0 + lp["ln2_g"], lp["ln2_b"]))
    return x + c


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_forward(cfg, params: Dict, tokens, *, use_kernel: bool = True):
    """tokens: [B,S] int -> logits [B,S,V_padded].  ``use_kernel=False``
    takes the kernels' plain versions (a reference run on the card)."""
    _check_ported(cfg)
    x = params["embed"][tokens]
    if cfg.family == "ssm":
        x = layer_norm(x, 1.0 + params["ln0_g"], params["ln0_b"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for _, lp in _layers(params, cfg):
        x = _apply_layer(lp, x, cfg, positions, use_kernel)
    return rms_norm(x, params["ln_f"], cfg.norm_eps) @ _head(cfg, params)


# ------------------------------------------------------------------ decode
def init_decode_cache(cfg, batch: int, cache_len: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Flat dict of stacked per-layer decode state, zeros on ``device``."""
    _check_ported(cfg)
    dtype = dtype_of(cfg)
    L, d = cfg.n_layers, cfg.d_model
    z = lambda *shape, dt=dtype: torch.zeros((L,) + shape, dtype=dt, device=device)
    if _kind(cfg) == "attn":
        kv = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"blocks/L0/k": z(*kv), "blocks/L0/v": z(*kv)}
    n = cfg.rwkv_head_dim
    return {
        "blocks/L0/s": z(batch, cfg.n_heads, n, n, dt=torch.float32),
        "blocks/L0/tm_last": z(batch, d),
        "blocks/L0/cm_last": z(batch, d),
    }


def _decode_layer(lp: Dict, lc: Dict, x1, cfg, pos):
    """One-token layer step, x1 [B,1,D]; writes the layer's cache views in
    place."""
    if _kind(cfg) == "attn":
        ap = sub(lp, "attn")
        b, hd = x1.shape[0], cfg.resolved_head_dim
        xa = rms_norm(x1, lp["ln1"], cfg.norm_eps)
        q, k, v = xa @ ap["wq"], xa @ ap["wk"], xa @ ap["wv"]
        if cfg.qkv_bias:
            q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
        posb = torch.full((b, 1), pos, device=x1.device)
        q = rope(q.reshape(b, 1, cfg.n_heads, hd), posb, cfg.rope_theta)
        k = rope(k.reshape(b, 1, cfg.n_kv_heads, hd), posb, cfg.rope_theta)
        lc["k"][:, pos] = k[:, 0]
        lc["v"][:, pos] = v.reshape(b, cfg.n_kv_heads, hd)
        o = decode_attention(q, lc["k"], lc["v"], pos)
        x1 = x1 + o.reshape(b, 1, cfg.n_heads * hd) @ ap["wo"]
        f = sub(lp, "ffn")
        return x1 + swiglu(rms_norm(x1, lp["ln2"], cfg.norm_eps), f["w_gate"], f["w_up"], f["w_down"])
    xt = layer_norm(x1, 1.0 + lp["ln1_g"], lp["ln1_b"])
    t, (s_new, tml) = rk.time_mix_decode(sub(lp, "tm"), xt, lc["s"], lc["tm_last"], cfg.n_heads, cfg.rwkv_head_dim)
    x1 = x1 + t
    xc = layer_norm(x1, 1.0 + lp["ln2_g"], lp["ln2_b"])
    c, cml = rk.channel_mix_decode(sub(lp, "cm"), xc, lc["cm_last"])
    lc["s"].copy_(s_new)
    lc["tm_last"].copy_(tml)
    lc["cm_last"].copy_(cml)
    return x1 + c


def lm_decode_step(cfg, params: Dict, cache: Dict, token, pos: int):
    """token [B] int, pos int -> (logits [B,V_padded], cache).

    Unlike the reference, which returns a new cache, this writes the step's
    keys and values (or recurrent state) into ``cache`` in place and returns
    it, so a decode holds one cache and copies none."""
    _check_ported(cfg)
    pos = int(pos)
    x1 = params["embed"][token][:, None, :]
    if cfg.family == "ssm":
        x1 = layer_norm(x1, 1.0 + params["ln0_g"], params["ln0_b"])
    stacked = sub(cache, "blocks/L0")
    for i, lp in _layers(params, cfg):
        x1 = _decode_layer(lp, {k: v[i] for k, v in stacked.items()}, x1, cfg, pos)
    logits = rms_norm(x1, params["ln_f"], cfg.norm_eps) @ _head(cfg, params)
    return logits[:, 0], cache
