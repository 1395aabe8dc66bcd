"""RWKV6 (Finch) time-mix and channel-mix, with data-dependent decay
[arXiv:2404.05892].

Prefill (``time_mix``) hands r, k, v, the log-decay and the bonus u to the
chunked WKV scan kernel (``kernels/rwkv6_scan``), which computes the
reference's chunked algorithm and returns the final state as well: the
``s_fin`` of ``time_mix`` is the kernel's own last state (the plain
version's on the CPU).  Decode is the O(1) recurrence in plain PyTorch:
out = r.(S + u*(k^T v)); S' = w*S + k^T v.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan.ops import rwkv6_wkv
from .common import batch_axes, shard_hint, split_heads


def _lerp(x, xprev, mu):
    return x + (xprev - x) * mu


def _token_shift(x, x_last=None):
    """Previous-token x; zeros (or carried state) at position 0."""
    first = torch.zeros_like(x[:, :1]) if x_last is None else x_last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix_params(reg, prefix, d, n_heads, head_dim, lora=64, dtype=torch.float32):
    p = prefix
    for mu in ("mu_x", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g"):
        reg.add(f"{p}/{mu}", (d,), ("embed",), zeros=True, dtype=dtype)
    for w in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        reg.add(f"{p}/{w}", (d, d), ("embed", "heads"), dtype=dtype)
    reg.add(f"{p}/w0", (d,), ("heads",), zeros=True, dtype=dtype)
    reg.add(f"{p}/w_lora_a", (d, lora), ("embed", "lora"), dtype=dtype)
    reg.add(f"{p}/w_lora_b", (lora, d), ("lora", "heads"), dtype=dtype, scale=1e-2)
    reg.add(f"{p}/u", (n_heads, head_dim), ("heads", "head_dim"), zeros=True, dtype=dtype)
    reg.add(f"{p}/gn_g", (d,), ("heads",), zeros=True, dtype=dtype)
    reg.add(f"{p}/gn_b", (d,), ("heads",), zeros=True, dtype=dtype)


def channel_mix_params(reg, prefix, d, d_ff, dtype=torch.float32):
    p = prefix
    reg.add(f"{p}/mu_k", (d,), ("embed",), zeros=True, dtype=dtype)
    reg.add(f"{p}/mu_r", (d,), ("embed",), zeros=True, dtype=dtype)
    reg.add(f"{p}/w_k", (d, d_ff), ("embed", "ff"), dtype=dtype)
    reg.add(f"{p}/w_v", (d_ff, d), ("ff", "embed"), dtype=dtype)
    reg.add(f"{p}/w_r", (d, d), ("embed", "heads"), dtype=dtype)


def _project(p, x, xprev):
    """Shared projection math for prefill and decode: returns r,k,v,g,logw."""
    xw = _lerp(x, xprev, p["mu_w"])
    xk = _lerp(x, xprev, p["mu_k"])
    xv = _lerp(x, xprev, p["mu_v"])
    xr = _lerp(x, xprev, p["mu_r"])
    xg = _lerp(x, xprev, p["mu_g"])
    r = xr @ p["w_r"]
    k = xk @ p["w_k"]
    v = xv @ p["w_v"]
    g = F.silu(xg @ p["w_g"])
    # data-dependent decay (the Finch contribution): per-channel, per-token
    dd = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp(p["w0"] + dd, -8.0, 6.0).float())
    return r, k, v, g, logw


def _group_norm(x, g, b, n_heads, eps=1e-5):
    """Per-head LayerNorm of the wkv output (RWKV GroupNorm(H))."""
    b_, t, d = x.shape
    xh = split_heads(x, n_heads, d // n_heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b_, t, d) * (1.0 + g) + b).to(x.dtype)


def time_mix(p, x, n_heads: int, head_dim: int, state=None, x_last=None, *, use_kernel: bool = True):
    """x: [B,T,D]. Returns (out [B,T,D], (state [B,H,N,N], x_last [B,D]))."""
    bsz, t, d = x.shape
    h, n = n_heads, head_dim
    xprev = _token_shift(x, x_last)
    r, k, v, g, logw = _project(p, x, xprev)
    # under a mesh the scan's operands meet its rule: batch over (pod,
    # data), heads over "model" (kernels/sharded.py)
    heads = lambda a: shard_hint(split_heads(a, h, n), batch_axes(), None, "model", None)
    s0 = None if state is None else state.float().contiguous()
    # the wkv output stays float32 up to the group norm, as in the reference
    wkv, s_fin = rwkv6_wkv(heads(r), heads(k), heads(v), heads(logw), p["u"].float(),
                           state=s0, out_dtype=torch.float32, use_kernel=use_kernel)
    out = _group_norm(wkv.reshape(bsz, t, d), p["gn_g"], p["gn_b"], h) * g
    out = out.to(x.dtype) @ p["w_o"]
    return out, (s_fin, x[:, -1])


def time_mix_decode(p, x1, state, x_last, n_heads: int, head_dim: int):
    """One-token decode. x1: [B,1,D]; state [B,H,N,N]; x_last [B,D]."""
    bsz, _, d = x1.shape
    h, n = n_heads, head_dim
    r, k, v, g, logw = _project(p, x1, x_last[:, None])
    rh, kh, vh = (split_heads(a, h, n)[:, 0].float() for a in (r, k, v))
    w = torch.exp(split_heads(logw, h, n)[:, 0])
    u = p["u"].float()
    kv = kh[..., :, None] * vh[..., None, :]
    out = torch.einsum("bhn,bhnm->bhm", rh, state + u[None, :, :, None] * kv)
    s_new = state * w[..., None] + kv
    out = _group_norm(out.reshape(bsz, 1, d), p["gn_g"], p["gn_b"], h) * g
    out = out.to(x1.dtype) @ p["w_o"]
    return out, (s_new, x1[:, 0])


def channel_mix(p, x, x_last=None):
    """Squared-ReLU channel mix. Returns (out, new x_last)."""
    xprev = _token_shift(x, x_last)
    xk = _lerp(x, xprev, p["mu_k"])
    xr = _lerp(x, xprev, p["mu_r"])
    k = torch.square(torch.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"]), x[:, -1]


def channel_mix_decode(p, x1, x_last):
    return channel_mix(p, x1, x_last)
