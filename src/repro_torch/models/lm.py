"""Decoder-only LM assembly of the port for every non-encoder-decoder
architecture: dense GQA (llama3, qwen, granite), MoE (qwen2-moe,
moonshot), RWKV6 (ssm), the RG-LRU hybrid (recurrentgemma, windowed
attention) and the VLM (pixtral, stubbed patch frontend): prefill and
cached one-token decode.

Parameters are a flat dict path -> tensor in the reference's layout: the
layer pattern (``("attn",)``, ``("rwkv",)`` or recurrentgemma's
``("rglru", "rglru", "attn")``) repeats ``n_full`` times, and the
parameters of pattern position i are stacked along a leading axis of
``n_full`` under ``blocks/L{i}/``; the remainder layers are unstacked
under ``rem{j}/``.  The forward loops over layers in Python, taking a view
of each.  When a gradient is needed, each stacked pattern block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable`` around its block body): the backward reruns the
block's forward, so its kernels launch twice per training step.  The
remainder layers are not rematerialised, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import rglru as rg
from . import rwkv6 as rk
from .attention import causal_attention, decode_attention
from .common import Registry, cross_entropy_loss, dtype_of, layer_norm, rms_norm, rope, sub, swiglu
from .moe import moe_ffn

VOCAB_PAD = 512


def padded_vocab(cfg) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _stack_pattern(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern kinds, number of stacked pattern blocks, remainder kinds)."""
    if cfg.family == "ssm":
        pat = ("rwkv",)
    elif cfg.block_pattern:
        pat = tuple(cfg.block_pattern)
    else:
        pat = ("attn",)
    n_full = cfg.n_layers // len(pat)
    rem = tuple(pat[i] for i in range(cfg.n_layers - n_full * len(pat)))
    return pat, n_full, rem


def _layers(tree: Dict, cfg) -> Iterator[Tuple[str, Dict]]:
    """(kind, per-layer view) for every layer in order, of parameters or of
    a decode cache: views of the stacked ``blocks/L{i}`` tensors, then the
    ``rem{j}`` entries.  The views come from one ``unbind`` per stacked
    tensor, whose backward stacks the layers' gradients once; indexing each
    layer would add a zero-filled gradient of the whole stack per layer."""
    pat, n_full, rem = _stack_pattern(cfg)
    stacked = [{k: v.unbind(0) for k, v in sub(tree, f"blocks/L{pi}").items()} for pi in range(len(pat))]
    for blk in range(n_full):
        for pi, kind in enumerate(pat):
            yield kind, {k: v[blk] for k, v in stacked[pi].items()}
    for ri, kind in enumerate(rem):
        yield kind, sub(tree, f"rem{ri}")


# --------------------------------------------------------------------- init
def _ffn_params(reg: Registry, prefix: str, cfg, dtype):
    d = cfg.d_model
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.moe_d_ff
        reg.add(f"{prefix}/router", (d, e), dtype=dtype)
        reg.add(f"{prefix}/w_gate", (e, d, f), dtype=dtype)
        reg.add(f"{prefix}/w_up", (e, d, f), dtype=dtype)
        reg.add(f"{prefix}/w_down", (e, f, d), dtype=dtype)
        if cfg.n_shared_experts:
            reg.add(f"{prefix}/sh_gate", (d, cfg.d_ff), dtype=dtype)
            reg.add(f"{prefix}/sh_up", (d, cfg.d_ff), dtype=dtype)
            reg.add(f"{prefix}/sh_down", (cfg.d_ff, d), dtype=dtype)
    else:
        reg.add(f"{prefix}/w_gate", (d, cfg.d_ff), dtype=dtype)
        reg.add(f"{prefix}/w_up", (d, cfg.d_ff), dtype=dtype)
        reg.add(f"{prefix}/w_down", (cfg.d_ff, d), dtype=dtype)


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


def _layer_params(reg: Registry, prefix: str, kind: str, cfg, dtype):
    d = cfg.d_model
    if kind in ("attn", "rglru"):
        reg.add(f"{prefix}/ln1", (d,), zeros=True, dtype=dtype)
        if kind == "attn":
            _attn_params(reg, f"{prefix}/attn", cfg, dtype)
        else:
            rg.rglru_params(reg, f"{prefix}/rec", d, cfg.d_rnn, cfg.conv_width, dtype)
        reg.add(f"{prefix}/ln2", (d,), zeros=True, dtype=dtype)
        _ffn_params(reg, f"{prefix}/ffn", cfg, dtype)
    elif kind == "rwkv":
        for ln in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            reg.add(f"{prefix}/{ln}", (d,), zeros=True, dtype=dtype)
        rk.time_mix_params(reg, f"{prefix}/tm", d, cfg.n_heads, cfg.rwkv_head_dim, dtype=dtype)
        rk.channel_mix_params(reg, f"{prefix}/cm", d, cfg.d_ff, dtype=dtype)
    else:
        raise ValueError(kind)


def init_lm(cfg, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    """Random parameters at the reference's scales, drawn on ``device`` from
    ``generator`` (which must live on the same device)."""
    dtype = dtype_of(cfg)
    reg = Registry(generator, device)
    d, v = cfg.d_model, padded_vocab(cfg)
    reg.add("embed", (v, d), scale=0.02, dtype=dtype)
    if cfg.family == "ssm":
        reg.add("ln0_g", (d,), zeros=True, dtype=dtype)
        reg.add("ln0_b", (d,), zeros=True, dtype=dtype)
    if cfg.family == "vlm":
        reg.add("patch_proj", (d, d), dtype=dtype)
    pat, n_full, rem = _stack_pattern(cfg)
    if n_full:
        blocks = Registry(generator, device, layers=n_full)
        for pi, kind in enumerate(pat):
            _layer_params(blocks, f"blocks/L{pi}", kind, cfg, dtype)
        reg.params.update(blocks.params)
    for ri, kind in enumerate(rem):
        _layer_params(reg, f"rem{ri}", kind, cfg, dtype)
    reg.add("ln_f", (d,), zeros=True, dtype=dtype)
    if not cfg.tie_embeddings:
        reg.add("lm_head", (d, v), scale=0.02, dtype=dtype)
    return reg.params


# ------------------------------------------------------------------- apply
def _ffn_apply(lp: Dict, x, cfg, *, decode: bool = False):
    if cfg.n_experts:
        # decode batches are small: dropless capacity (a served token is
        # never dropped by the router), as in the reference
        cap = float(cfg.n_experts) / cfg.top_k if decode else cfg.capacity_factor
        y = moe_ffn(x, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"], top_k=cfg.top_k, capacity_factor=cap)
        if cfg.n_shared_experts:
            y = y + swiglu(x, lp["sh_gate"], lp["sh_up"], lp["sh_down"])
        return y
    return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])


def _qkv(ap: Dict, x, cfg, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ ap["wq"], x @ ap["wk"], x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = rope(q.reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, hd)


def _apply_layer(kind: str, lp: Dict, x, cfg, positions, use_kernel: bool):
    if kind == "attn":
        q, k, v = _qkv(sub(lp, "attn"), rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, positions)
        o = causal_attention(q, k, v, local_window=cfg.local_window, use_kernel=use_kernel)
        x = x + o.reshape(x.shape[0], x.shape[1], -1) @ lp["attn/wo"]
        return x + _ffn_apply(sub(lp, "ffn"), rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    if kind == "rglru":
        r, _ = rg.rglru_block(sub(lp, "rec"), rms_norm(x, lp["ln1"], cfg.norm_eps))
        x = x + r
        return x + _ffn_apply(sub(lp, "ffn"), rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    t, _ = rk.time_mix(sub(lp, "tm"), layer_norm(x, 1.0 + lp["ln1_g"], lp["ln1_b"]),
                       cfg.n_heads, cfg.rwkv_head_dim, use_kernel=use_kernel)
    x = x + t
    c, _ = rk.channel_mix(sub(lp, "cm"), layer_norm(x, 1.0 + lp["ln2_g"], lp["ln2_b"]))
    return x + c


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def embed_inputs(cfg, params: Dict, tokens, patch_embeds=None):
    """The residual stream's input [B, S_total, D]: token embeddings, after
    the projected patch embeddings for a VLM (layer-normed for RWKV6)."""
    x = params["embed"][tokens]
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError(f"{cfg.name} takes patch_embeds [B, {cfg.n_patches}, {cfg.d_model}]")
        x = torch.cat([patch_embeds.to(x.dtype) @ params["patch_proj"], x], dim=1)
    if cfg.family == "ssm":
        x = layer_norm(x, 1.0 + params["ln0_g"], params["ln0_b"])
    return x


def lm_forward(cfg, params: Dict, tokens, patch_embeds=None, *, use_kernel: bool = True):
    """tokens: [B,S_text] int -> logits [B,S_total,V_padded] (S_total counts
    a VLM's patches first).  ``use_kernel=False`` takes the kernels' plain
    versions (a reference run on the card)."""
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)

    def run(xc, layers):
        for kind, lp in layers:
            xc = _apply_layer(kind, lp, xc, cfg, positions, use_kernel)
        return xc

    layers = list(_layers(params, cfg))
    pat, n_blocks, _ = _stack_pattern(cfg)
    per_block = len(pat)
    remat = torch.is_grad_enabled() and any(p.requires_grad for p in params.values())
    for blk in range(n_blocks):
        group = layers[blk * per_block:(blk + 1) * per_block]
        x = checkpoint(run, x, group, use_reentrant=False, preserve_rng_state=False) if remat else run(x, group)
    x = run(x, layers[n_blocks * per_block:])
    return rms_norm(x, params["ln_f"], cfg.norm_eps) @ _head(cfg, params)


def lm_loss(cfg, params: Dict, batch: Dict, *, use_kernel: bool = True):
    """batch: tokens [B,S], labels [B,S] (-1 = masked), optional
    patch_embeds.  A VLM's patch positions are dropped before the loss."""
    logits = lm_forward(cfg, params, batch["tokens"], batch.get("patch_embeds"), use_kernel=use_kernel)
    if cfg.family == "vlm":
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    logits = logits[..., : cfg.vocab_size]
    labels = batch["labels"]
    return cross_entropy_loss(logits, torch.clamp(labels, min=0), mask=labels >= 0)


# ------------------------------------------------------------------ decode
def _kind_cache(cfg, kind: str, batch: int, cache_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each decode-cache entry of one layer of ``kind``."""
    dtype = dtype_of(cfg)
    if kind == "attn":
        sl = min(cache_len, cfg.local_window) if cfg.local_window else cache_len
        kv = (batch, sl, cfg.n_kv_heads, cfg.resolved_head_dim)
        if cfg.kv_cache_dtype == "int8":  # per-(token, head) scales beside the int8 values
            scale = ((batch, sl, cfg.n_kv_heads), torch.float32)
            return {"k": (kv, torch.int8), "v": (kv, torch.int8), "k_scale": scale, "v_scale": scale}
        return {"k": (kv, dtype), "v": (kv, dtype)}
    if kind == "rglru":
        return {"h": ((batch, cfg.d_rnn), torch.float32),
                "conv": ((batch, cfg.conv_width - 1, cfg.d_rnn), dtype)}
    n = cfg.rwkv_head_dim
    return {"s": ((batch, cfg.n_heads, n, n), torch.float32),
            "tm_last": ((batch, cfg.d_model), dtype), "cm_last": ((batch, cfg.d_model), dtype)}


def init_decode_cache(cfg, batch: int, cache_len: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Flat dict of per-layer decode state, zeros on ``device``, in the
    parameters' layout (stacked under ``blocks/L{i}/``, then ``rem{j}/``).
    An attention layer with a local window keeps a ring of ``min(cache_len,
    local_window)`` slots."""
    pat, n_full, rem = _stack_pattern(cfg)
    cache = {}
    for prefix, kind, lead in ([(f"blocks/L{pi}", kind, (n_full,) if n_full else ()) for pi, kind in enumerate(pat)]
                               + [(f"rem{ri}", kind, ()) for ri, kind in enumerate(rem)]):
        for name, (shape, dt) in _kind_cache(cfg, kind, batch, cache_len).items():
            cache[f"{prefix}/{name}"] = torch.zeros(lead + shape, dtype=dt, device=device)
    return cache


def _quantize(t):
    """absmax int8 per (token, head), rounding half to even as the
    reference's ``jnp.round``: (values, float32 scales)."""
    sc = torch.clamp(t.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(t / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc.float()


def _decode_attn(lp: Dict, lc: Dict, x1, cfg, pos: int):
    b, hd = x1.shape[0], cfg.resolved_head_dim
    posb = torch.full((b, 1), pos, device=x1.device)
    q, k, v = _qkv(sub(lp, "attn"), rms_norm(x1, lp["ln1"], cfg.norm_eps), cfg, posb)
    sl = lc["k"].shape[1]
    slot = pos % sl if cfg.local_window else pos  # a ring of the last sl positions
    if cfg.kv_cache_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            qt, sc = _quantize(t[:, 0])
            lc[name][:, slot] = qt
            lc[f"{name}_scale"][:, slot] = sc
        kf = lc["k"].to(k.dtype) * lc["k_scale"][..., None].to(k.dtype)
        vf = lc["v"].to(v.dtype) * lc["v_scale"][..., None].to(v.dtype)
    else:
        lc["k"][:, slot] = k[:, 0]
        lc["v"][:, slot] = v[:, 0]
        kf, vf = lc["k"], lc["v"]
    # once the ring is full every slot lies in the window; until then the
    # slots past pos are masked
    eff_pos = min(pos, sl - 1) if cfg.local_window else pos
    o = decode_attention(q, kf, vf, eff_pos)
    x1 = x1 + o.reshape(b, 1, cfg.n_heads * hd) @ lp["attn/wo"]
    return x1 + _ffn_apply(sub(lp, "ffn"), rms_norm(x1, lp["ln2"], cfg.norm_eps), cfg, decode=True)


def _decode_layer(kind: str, lp: Dict, lc: Dict, x1, cfg, pos: int):
    """One-token layer step, x1 [B,1,D]; writes the layer's cache views in
    place."""
    if kind == "attn":
        return _decode_attn(lp, lc, x1, cfg, pos)
    if kind == "rglru":
        r, (h, conv) = rg.rglru_decode(sub(lp, "rec"), rms_norm(x1, lp["ln1"], cfg.norm_eps), lc["h"], lc["conv"])
        lc["h"].copy_(h)
        lc["conv"].copy_(conv)
        x1 = x1 + r
        return x1 + _ffn_apply(sub(lp, "ffn"), rms_norm(x1, lp["ln2"], cfg.norm_eps), cfg, decode=True)
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
    pos = int(pos)
    x1 = params["embed"][token][:, None, :]
    if cfg.family == "ssm":
        x1 = layer_norm(x1, 1.0 + params["ln0_g"], params["ln0_b"])
    for (kind, lp), (_, lc) in zip(_layers(params, cfg), _layers(cache, cfg)):
        x1 = _decode_layer(kind, lp, lc, x1, cfg, pos)
    logits = rms_norm(x1, params["ln_f"], cfg.norm_eps) @ _head(cfg, params)
    return logits[:, 0], cache
