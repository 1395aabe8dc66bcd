"""Whisper-style encoder-decoder (whisper-tiny backbone, arXiv:2212.04356).

The conv1d+GELU audio frontend is a stub, as in the reference:
``enc_embeds`` arrive precomputed as [B, enc_seq, d_model] frame
embeddings.  Both stacks use pre-LayerNorm blocks with GELU MLPs and biased
projections (``bq``, ``bv``, ``bo``; no ``bk``); sinusoidal positions stand
in for Whisper's learned decoder positions, as in the reference.  The
layers are stacked along a leading axis under ``enc/`` and ``dec/``.

The decoder's causal self-attention in prefill goes through the flash
kernel; the encoder's self-attention (non-causal) and the cross attention
are plain PyTorch, as the reference computes them in jnp.  Decode writes
the self-attention cache in place (``whisper_prime_cache`` fills the cross
cache, also in place).
"""
from __future__ import annotations

from typing import Dict

import torch

from .attention import causal_attention, cross_attention, decode_attention
from .common import Registry, cross_entropy_loss, dtype_of, gelu_mlp, layer_norm, sinusoidal_positions, sub


def _attn_p(reg, prefix, cfg, dtype):
    d = cfg.d_model
    h = cfg.n_heads * cfg.resolved_head_dim
    for w, shape in (("wq", (d, h)), ("wk", (d, h)), ("wv", (d, h)), ("wo", (h, d))):
        reg.add(f"{prefix}/{w}", shape, dtype=dtype)
    for b, n in (("bq", h), ("bv", h), ("bo", d)):
        reg.add(f"{prefix}/{b}", (n,), zeros=True, dtype=dtype)


def _mlp_p(reg, prefix, cfg, dtype):
    d, f = cfg.d_model, cfg.d_ff
    reg.add(f"{prefix}/w1", (d, f), dtype=dtype)
    reg.add(f"{prefix}/b1", (f,), zeros=True, dtype=dtype)
    reg.add(f"{prefix}/w2", (f, d), dtype=dtype)
    reg.add(f"{prefix}/b2", (d,), zeros=True, dtype=dtype)


def _ln_p(reg, prefix, cfg, dtype):
    reg.add(f"{prefix}_g", (cfg.d_model,), zeros=True, dtype=dtype)
    reg.add(f"{prefix}_b", (cfg.d_model,), zeros=True, dtype=dtype)


def init_whisper(cfg, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    from .lm import padded_vocab

    dtype = dtype_of(cfg)
    reg = Registry(generator, device)
    reg.add("embed", (padded_vocab(cfg), cfg.d_model), scale=0.02, dtype=dtype)
    for name, n, cross in (("enc", cfg.n_enc_layers, False), ("dec", cfg.n_layers, True)):
        blk = Registry(generator, device, layers=n)
        _ln_p(blk, f"{name}/ln1", cfg, dtype)
        _attn_p(blk, f"{name}/self", cfg, dtype)
        if cross:
            _ln_p(blk, f"{name}/ln2", cfg, dtype)
            _attn_p(blk, f"{name}/cross", cfg, dtype)
        _ln_p(blk, f"{name}/ln3", cfg, dtype)
        _mlp_p(blk, f"{name}/mlp", cfg, dtype)
        reg.params.update(blk.params)
    _ln_p(reg, "enc_lnf", cfg, dtype)
    _ln_p(reg, "dec_lnf", cfg, dtype)
    return reg.params


def _stack(params: Dict, name: str, n: int):
    """Per-layer views of the stacked ``{name}/...`` tensors, from one
    ``unbind`` per tensor (see ``lm._layers``)."""
    stacked = {k: v.unbind(0) for k, v in sub(params, name).items()}
    for i in range(n):
        yield {k: v[i] for k, v in stacked.items()}


def _heads(t, cfg):
    return t.reshape(t.shape[0], t.shape[1], cfg.n_heads, cfg.resolved_head_dim)


def _proj_qkv(p, x, cfg):
    return _heads(x @ p["wq"] + p["bq"], cfg), _heads(x @ p["wk"], cfg), _heads(x @ p["wv"] + p["bv"], cfg)


def _cross_kv(p, enc, cfg):
    return _heads(enc @ p["wk"], cfg), _heads(enc @ p["wv"] + p["bv"], cfg)


def _out(p, o):
    return o.reshape(o.shape[0], o.shape[1], -1) @ p["wo"] + p["bo"]


def _mlp(lp, x):
    xm = layer_norm(x, 1.0 + lp["ln3_g"], lp["ln3_b"])
    mp = sub(lp, "mlp")
    return x + gelu_mlp(xm, mp["w1"], mp["b1"], mp["w2"], mp["b2"])


def _positions(cfg, s: int, like):
    return sinusoidal_positions(s, cfg.d_model).to(device=like.device, dtype=like.dtype)[None]


def whisper_encode(cfg, params: Dict, enc_embeds):
    x = enc_embeds.to(params["embed"].dtype)  # the model's dtype (float32 when the weights are cast)
    x = x + _positions(cfg, x.shape[1], x)
    for lp in _stack(params, "enc", cfg.n_enc_layers):
        q, k, v = _proj_qkv(sub(lp, "self"), layer_norm(x, 1.0 + lp["ln1_g"], lp["ln1_b"]), cfg)
        x = _mlp(lp, x + _out(sub(lp, "self"), cross_attention(q, k, v)))
    return layer_norm(x, 1.0 + params["enc_lnf_g"], params["enc_lnf_b"])


def whisper_forward(cfg, params: Dict, enc_embeds, tokens, *, use_kernel: bool = True):
    """Teacher-forced decoder over the full token sequence -> logits
    [B, S, V_padded].  ``use_kernel=False`` takes flash's plain version."""
    enc = whisper_encode(cfg, params, enc_embeds)
    x = params["embed"][tokens]
    x = x + _positions(cfg, x.shape[1], x)
    for lp in _stack(params, "dec", cfg.n_layers):
        sp, cp = sub(lp, "self"), sub(lp, "cross")
        q, k, v = _proj_qkv(sp, layer_norm(x, 1.0 + lp["ln1_g"], lp["ln1_b"]), cfg)
        x = x + _out(sp, causal_attention(q, k, v, use_kernel=use_kernel))
        q2 = _heads(layer_norm(x, 1.0 + lp["ln2_g"], lp["ln2_b"]) @ cp["wq"] + cp["bq"], cfg)
        x = _mlp(lp, x + _out(cp, cross_attention(q2, *_cross_kv(cp, enc, cfg))))
    x = layer_norm(x, 1.0 + params["dec_lnf_g"], params["dec_lnf_b"])
    return x @ params["embed"].T


def whisper_loss(cfg, params: Dict, batch: Dict, *, use_kernel: bool = True):
    """batch: enc_embeds [B,F,D], tokens [B,S], labels [B,S] (-1 = masked)."""
    logits = whisper_forward(cfg, params, batch["enc_embeds"], batch["tokens"], use_kernel=use_kernel)
    logits = logits[..., : cfg.vocab_size]
    labels = batch["labels"]
    return cross_entropy_loss(logits, torch.clamp(labels, min=0), mask=labels >= 0)


# ------------------------------------------------------------------ decode
def init_whisper_cache(cfg, batch: int, cache_len: int, device: torch.device) -> Dict[str, torch.Tensor]:
    dtype = dtype_of(cfg)
    lead = (cfg.n_layers, batch)
    heads = (cfg.n_heads, cfg.resolved_head_dim)
    z = lambda s: torch.zeros(lead + (s,) + heads, dtype=dtype, device=device)
    return {"self_k": z(cache_len), "self_v": z(cache_len), "cross_k": z(cfg.enc_seq_len),
            "cross_v": z(cfg.enc_seq_len)}


def whisper_prime_cache(cfg, params: Dict, cache: Dict, enc_embeds):
    """Writes each decoder layer's cross K/V of the encoder output into
    ``cache`` in place, and returns it."""
    enc = whisper_encode(cfg, params, enc_embeds)
    for i, lp in enumerate(_stack(params, "dec", cfg.n_layers)):
        ek, ev = _cross_kv(sub(lp, "cross"), enc, cfg)
        cache["cross_k"][i].copy_(ek)
        cache["cross_v"][i].copy_(ev)
    return cache


def whisper_decode_step(cfg, params: Dict, cache: Dict, token, pos: int):
    """token [B] int, pos int -> (logits [B,V_padded], cache), the step's
    self-attention keys and values written into ``cache`` in place."""
    pos = int(pos)
    x1 = params["embed"][token][:, None, :]
    # the current position's sinusoid, in float32 as the reference computes it
    dim = torch.arange(cfg.d_model // 2, dtype=torch.float32, device=x1.device)
    ang = float(pos) / torch.pow(torch.tensor(10000.0, device=x1.device), 2 * dim / cfg.d_model)
    x1 = x1 + torch.cat([torch.sin(ang), torch.cos(ang)])[None, None].to(x1.dtype)
    for i, lp in enumerate(_stack(params, "dec", cfg.n_layers)):
        sp, cp = sub(lp, "self"), sub(lp, "cross")
        q, k, v = _proj_qkv(sp, layer_norm(x1, 1.0 + lp["ln1_g"], lp["ln1_b"]), cfg)
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        sk[:, pos] = k[:, 0]
        sv[:, pos] = v[:, 0]
        x1 = x1 + _out(sp, decode_attention(q, sk, sv, pos))
        q2 = _heads(layer_norm(x1, 1.0 + lp["ln2_g"], lp["ln2_b"]) @ cp["wq"] + cp["bq"], cfg)
        x1 = _mlp(lp, x1 + _out(cp, cross_attention(q2, cache["cross_k"][i], cache["cross_v"][i])))
    x1 = layer_norm(x1, 1.0 + params["dec_lnf_g"], params["dec_lnf_b"])
    return (x1 @ params["embed"].T)[:, 0], cache

