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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import rglru as rg
from . import rwkv6 as rk
from .attention import causal_attention, decode_attention
from .common import (Registry, act_hint, batch_axes, cross_entropy_loss, dtype_of, layer_norm, merge_heads, rms_norm,
                     rope, shard_hint, split_heads, sub, swiglu, write_position)
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
        reg.add(f"{prefix}/router", (d, e), ("embed", "expert_in"), dtype=dtype)
        reg.add(f"{prefix}/w_gate", (e, d, f), ("expert", "embed", "expert_ff"), dtype=dtype)
        reg.add(f"{prefix}/w_up", (e, d, f), ("expert", "embed", "expert_ff"), dtype=dtype)
        reg.add(f"{prefix}/w_down", (e, f, d), ("expert", "expert_ff", "embed"), dtype=dtype)
        if cfg.n_shared_experts:
            reg.add(f"{prefix}/sh_gate", (d, cfg.d_ff), ("embed", "ff"), dtype=dtype)
            reg.add(f"{prefix}/sh_up", (d, cfg.d_ff), ("embed", "ff"), dtype=dtype)
            reg.add(f"{prefix}/sh_down", (cfg.d_ff, d), ("ff", "embed"), dtype=dtype)
    else:
        reg.add(f"{prefix}/w_gate", (d, cfg.d_ff), ("embed", "ff"), dtype=dtype)
        reg.add(f"{prefix}/w_up", (d, cfg.d_ff), ("embed", "ff"), dtype=dtype)
        reg.add(f"{prefix}/w_down", (cfg.d_ff, d), ("ff", "embed"), dtype=dtype)


def _attn_params(reg: Registry, prefix: str, cfg, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    reg.add(f"{prefix}/wq", (d, cfg.n_heads * hd), ("embed", "heads"), dtype=dtype)
    reg.add(f"{prefix}/wk", (d, cfg.n_kv_heads * hd), ("embed", "kv_heads"), dtype=dtype)
    reg.add(f"{prefix}/wv", (d, cfg.n_kv_heads * hd), ("embed", "kv_heads"), dtype=dtype)
    reg.add(f"{prefix}/wo", (cfg.n_heads * hd, d), ("heads", "embed"), dtype=dtype)
    if cfg.qkv_bias:
        reg.add(f"{prefix}/bq", (cfg.n_heads * hd,), ("heads",), zeros=True, dtype=dtype)
        reg.add(f"{prefix}/bk", (cfg.n_kv_heads * hd,), ("kv_heads",), zeros=True, dtype=dtype)
        reg.add(f"{prefix}/bv", (cfg.n_kv_heads * hd,), ("kv_heads",), zeros=True, dtype=dtype)


def _layer_params(reg: Registry, prefix: str, kind: str, cfg, dtype):
    d = cfg.d_model
    if kind in ("attn", "rglru"):
        reg.add(f"{prefix}/ln1", (d,), ("embed",), zeros=True, dtype=dtype)
        if kind == "attn":
            _attn_params(reg, f"{prefix}/attn", cfg, dtype)
        else:
            rg.rglru_params(reg, f"{prefix}/rec", d, cfg.d_rnn, cfg.conv_width, dtype)
        reg.add(f"{prefix}/ln2", (d,), ("embed",), zeros=True, dtype=dtype)
        _ffn_params(reg, f"{prefix}/ffn", cfg, dtype)
    elif kind == "rwkv":
        for ln in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            reg.add(f"{prefix}/{ln}", (d,), ("embed",), zeros=True, dtype=dtype)
        rk.time_mix_params(reg, f"{prefix}/tm", d, cfg.n_heads, cfg.rwkv_head_dim, dtype=dtype)
        rk.channel_mix_params(reg, f"{prefix}/cm", d, cfg.d_ff, dtype=dtype)
    else:
        raise ValueError(kind)


def init_lm(cfg, generator, device: torch.device) -> Registry:
    """Random parameters at the reference's scales, drawn on ``device`` from
    ``generator`` (which must live on the same device), and their logical
    axes: ``.params`` and ``.axes`` of the returned registry."""
    dtype = dtype_of(cfg)
    reg = Registry(generator, device)
    d, v = cfg.d_model, padded_vocab(cfg)
    reg.add("embed", (v, d), ("vocab", "embed"), scale=0.02, dtype=dtype)
    if cfg.family == "ssm":
        reg.add("ln0_g", (d,), ("embed",), zeros=True, dtype=dtype)
        reg.add("ln0_b", (d,), ("embed",), zeros=True, dtype=dtype)
    if cfg.family == "vlm":
        reg.add("patch_proj", (d, d), ("embed", "embed2"), dtype=dtype)
    pat, n_full, rem = _stack_pattern(cfg)
    if n_full:
        blocks = Registry(generator, device, layers=n_full)
        for pi, kind in enumerate(pat):
            _layer_params(blocks, f"blocks/L{pi}", kind, cfg, dtype)
        reg.params.update(blocks.params)
        reg.axes.update(blocks.axes)
    for ri, kind in enumerate(rem):
        _layer_params(reg, f"rem{ri}", kind, cfg, dtype)
    reg.add("ln_f", (d,), ("embed",), zeros=True, dtype=dtype)
    if not cfg.tie_embeddings:
        reg.add("lm_head", (d, v), ("embed", "vocab"), scale=0.02, dtype=dtype)
    return reg


# ------------------------------------------------------------------- apply
# ZeRO-3 weight gathering (the reference's): FSDP keeps weights sharded over
# "data" at rest; before use each weight is constrained to (replicated over
# data x TP-sharded), one weight all-gather per layer instead of
# activation all-reduces per token.  A MoE's expert weights stay sharded
# (EP over "model" when E divides it, else the expert-ff width).
_GATHER_SPECS = {
    "attn/wq": (None, "model"), "attn/wk": (None, "model"),
    "attn/wv": (None, "model"), "attn/wo": ("model", None),
    "ffn/w_gate": (None, "model"), "ffn/w_up": (None, "model"),
    "ffn/w_down": ("model", None),
    "ffn/router": (None, None),
    ("ffn/w_gate", 3): ("model", None, "model"),
    ("ffn/w_up", 3): ("model", None, "model"),
    ("ffn/w_down", 3): ("model", "model", None),
    "ffn/sh_gate": (None, "model"), "ffn/sh_up": (None, "model"),
    "ffn/sh_down": ("model", None),
    "rec/w_x": (None, "model"), "rec/w_gate": (None, "model"),
    "rec/w_out": ("model", None),
    "rec/w_a": ("model", None), "rec/w_i": ("model", None),
    "tm/w_r": (None, "model"), "tm/w_k": (None, "model"),
    "tm/w_v": (None, "model"), "tm/w_g": (None, "model"),
    "tm/w_o": (None, "model"),
    "cm/w_k": (None, "model"), "cm/w_v": ("model", None),
    "cm/w_r": (None, "model"),
}


def _gather_weights(lp: Dict) -> Dict:
    out = dict(lp)
    for k, v in lp.items():
        spec = _GATHER_SPECS.get((k, v.dim()), _GATHER_SPECS.get(k))
        if spec is not None and len(spec) == v.dim():
            out[k] = shard_hint(v, *spec)
    return out


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


def _qkv(ap: Dict, x, cfg, positions, hint=lambda t: t):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = hint(x @ ap["wq"]), hint(x @ ap["wk"]), hint(x @ ap["wv"])
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = rope(split_heads(q, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(split_heads(k, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    return q, k, split_heads(v, cfg.n_kv_heads, hd)


def _gathered(x):
    """A layer's input with the sequence whole (batch over (pod, data)):
    the sequence-parallel layout between blocks ends here, as Megatron's
    all-gather before the column-parallel products; a DTensor that merged a
    sharded batch with a sharded sequence in a product would be sharded
    twice over one dim."""
    return shard_hint(x, batch_axes(), None, None)


def _scattered(y):
    """A layer branch's output in the sequence-parallel layout (Megatron's
    reduce-scatter after the row-parallel product), before it joins the
    residual stream: its gradient then comes back gathered over the
    sequence to the product, never sharded over batch and sequence at
    once."""
    return shard_hint(y, batch_axes(), "model", None)


def _apply_layer(kind: str, lp: Dict, x, cfg, positions, use_kernel: bool):
    lp = _gather_weights(lp)
    if kind == "attn":
        q, k, v = _qkv(sub(lp, "attn"), _gathered(rms_norm(x, lp["ln1"], cfg.norm_eps)), cfg, positions, act_hint)
        o = causal_attention(q, k, v, local_window=cfg.local_window, use_kernel=use_kernel)
        x = x + _scattered(merge_heads(o) @ lp["attn/wo"])
        return x + _scattered(_ffn_apply(sub(lp, "ffn"), _gathered(rms_norm(x, lp["ln2"], cfg.norm_eps)), cfg))
    if kind == "rglru":
        r, _ = rg.rglru_block(sub(lp, "rec"), _gathered(rms_norm(x, lp["ln1"], cfg.norm_eps)))
        x = x + _scattered(r)
        return x + _scattered(_ffn_apply(sub(lp, "ffn"), _gathered(rms_norm(x, lp["ln2"], cfg.norm_eps)), cfg))
    t, _ = rk.time_mix(sub(lp, "tm"), _gathered(layer_norm(x, 1.0 + lp["ln1_g"], lp["ln1_b"])),
                       cfg.n_heads, cfg.rwkv_head_dim, use_kernel=use_kernel)
    x = x + _scattered(t)
    c, _ = rk.channel_mix(sub(lp, "cm"), _gathered(layer_norm(x, 1.0 + lp["ln2_g"], lp["ln2_b"])))
    return x + _scattered(c)


def _head(cfg, params):
    """The [D, V] output projection, under a mesh gathered over "data" with
    the vocab over "model" (as ``_gather_weights`` gathers the layers'
    weights), so the logits come out vocab-parallel."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shard_hint(head, None, "model")


def embed_inputs(cfg, params: Dict, tokens, patch_embeds=None):
    """The residual stream's input [B, S_total, D]: token embeddings, after
    the projected patch embeddings for a VLM (layer-normed for RWKV6)."""
    # under a mesh the table is gathered over "data" first (vocab over
    # "model"), as the layers' weights are, and the lookup keeps the batch
    # sharded (an embedding op: its backward has DTensor sharding rules of
    # its own, where indexing's scatter has none that hold)
    x = _gathered(F.embedding(tokens, shard_hint(params["embed"], "model", None)))
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

    # activation layout between blocks: batch over (pod, data), sequence
    # over "model" (the reference's sequence parallelism)
    def hint(xc):
        return shard_hint(xc, batch_axes(), "model", None)

    def run(xc, layers):
        for kind, lp in layers:
            xc = _apply_layer(kind, lp, xc, cfg, positions, use_kernel)
        return xc

    def block(xc, layers):
        return hint(run(xc, layers))

    layers = list(_layers(params, cfg))
    pat, n_blocks, _ = _stack_pattern(cfg)
    per_block = len(pat)
    remat = torch.is_grad_enabled() and any(p.requires_grad for p in params.values())
    x = hint(x)
    for blk in range(n_blocks):
        group = layers[blk * per_block:(blk + 1) * per_block]
        x = checkpoint(block, x, group, use_reentrant=False, preserve_rng_state=False) if remat else block(x, group)
    x = run(x, layers[n_blocks * per_block:])
    return _gathered(rms_norm(x, params["ln_f"], cfg.norm_eps)) @ _head(cfg, params)


def lm_loss(cfg, params: Dict, batch: Dict, *, use_kernel: bool = True):
    """batch: tokens [B,S], labels [B,S] (-1 = masked), optional
    patch_embeds.  A VLM's patch positions are dropped before the loss."""
    logits = lm_forward(cfg, params, batch["tokens"], batch.get("patch_embeds"), use_kernel=use_kernel)
    if cfg.family == "vlm":
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    labels = batch["labels"]
    return cross_entropy_loss(logits, torch.clamp(labels, min=0), mask=labels >= 0, vocab=cfg.vocab_size)


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


def decode_cache_axes(cfg) -> Dict[str, Tuple[str, ...]]:
    """Logical axes of every decode-cache entry (mirrors ``init_decode_cache``)."""
    pat, n_full, rem = _stack_pattern(cfg)

    def kind_axes(kind: str, prefix: str, stacked: bool):
        lead = ("layers",) if stacked else ()
        if kind == "attn":
            a = lead + ("cache_batch", "cache_seq", "kv_heads", "head_dim")
            out = {f"{prefix}/k": a, f"{prefix}/v": a}
            if cfg.kv_cache_dtype == "int8":
                sc = lead + ("cache_batch", "cache_seq", "kv_heads")
                out[f"{prefix}/k_scale"] = sc
                out[f"{prefix}/v_scale"] = sc
            return out
        if kind == "rglru":
            return {f"{prefix}/h": lead + ("cache_batch", "rnn"), f"{prefix}/conv": lead + ("cache_batch", "conv", "rnn")}
        return {f"{prefix}/s": lead + ("cache_batch", "heads", "head_dim", "head_dim"),
                f"{prefix}/tm_last": lead + ("cache_batch", "hidden"),
                f"{prefix}/cm_last": lead + ("cache_batch", "hidden")}

    axes: Dict = {}
    for pi, kind in enumerate(pat):
        axes.update(kind_axes(kind, f"blocks/L{pi}", bool(n_full)))
    for ri, kind in enumerate(rem):
        axes.update(kind_axes(kind, f"rem{ri}", False))
    return axes


def _quantize(t):
    """absmax int8 per (token, head), rounding half to even as the
    reference's ``jnp.round``: (values, float32 scales)."""
    sc = torch.clamp(t.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(t / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc.float()


def _decode_attn(lp: Dict, lc: Dict, x1, cfg, pos: int):
    posb = torch.full((x1.shape[0], 1), pos, device=x1.device)
    q, k, v = _qkv(sub(lp, "attn"), rms_norm(x1, lp["ln1"], cfg.norm_eps), cfg, posb)
    sl = lc["k"].shape[1]
    slot = pos % sl if cfg.local_window else pos  # a ring of the last sl positions
    if cfg.kv_cache_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            qt, sc = _quantize(t)
            write_position(lc[name], slot, qt)
            write_position(lc[f"{name}_scale"], slot, sc)
        kf = lc["k"].to(k.dtype) * lc["k_scale"][..., None].to(k.dtype)
        vf = lc["v"].to(v.dtype) * lc["v_scale"][..., None].to(v.dtype)
    else:
        write_position(lc["k"], slot, k)
        write_position(lc["v"], slot, v)
        kf, vf = lc["k"], lc["v"]
    # once the ring is full every slot lies in the window; until then the
    # slots past pos are masked
    eff_pos = min(pos, sl - 1) if cfg.local_window else pos
    o = decode_attention(q, kf, vf, eff_pos)
    x1 = x1 + merge_heads(o) @ lp["attn/wo"]
    return x1 + _ffn_apply(sub(lp, "ffn"), rms_norm(x1, lp["ln2"], cfg.norm_eps), cfg, decode=True)


def _decode_layer(kind: str, lp: Dict, lc: Dict, x1, cfg, pos: int):
    """One-token layer step, x1 [B,1,D]; writes the layer's cache views in
    place."""
    lp = _gather_weights(lp)
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
    x1 = shard_hint(F.embedding(token, shard_hint(params["embed"], "model", None)), batch_axes(), None)[:, None, :]
    if cfg.family == "ssm":
        x1 = layer_norm(x1, 1.0 + params["ln0_g"], params["ln0_b"])
    for (kind, lp), (_, lc) in zip(_layers(params, cfg), _layers(cache, cfg)):
        x1 = _decode_layer(kind, lp, lc, x1, cfg, pos)
    logits = rms_norm(x1, params["ln_f"], cfg.norm_eps) @ _head(cfg, params)
    return logits[:, 0], cache
