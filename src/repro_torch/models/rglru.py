"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Block: W_x -> causal depthwise conv1d (width 4) -> RG-LRU, gated by a GeLU
branch, projected back.  The RG-LRU diagonal recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    log a_t = -c * softplus(Lambda) * r_t,   c = 8

runs over time as a doubling scan in float32: log2 T steps of the pair
combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), the operator of the
reference's ``lax.associative_scan``, over the whole [B, T, C] state at
once.  (A ``cumprod`` of the decays would underflow.)  It is plain
PyTorch, as the reference's scan is jnp: no TPU kernel computes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import gelu

RG_C = 8.0


def rglru_params(reg, prefix, d, d_rnn, conv_width=4, dtype=torch.float32):
    p = prefix
    reg.add(f"{p}/w_x", (d, d_rnn), ("embed", "rnn"), dtype=dtype)
    reg.add(f"{p}/w_gate", (d, d_rnn), ("embed", "rnn"), dtype=dtype)
    reg.add(f"{p}/w_out", (d_rnn, d), ("rnn", "embed"), dtype=dtype)
    reg.add(f"{p}/conv_w", (conv_width, d_rnn), ("conv", "rnn"), dtype=dtype, scale=0.5)
    reg.add(f"{p}/conv_b", (d_rnn,), ("rnn",), zeros=True, dtype=dtype)
    reg.add(f"{p}/w_a", (d_rnn, d_rnn), ("rnn", "rnn2"), dtype=dtype, scale=1e-2)
    reg.add(f"{p}/b_a", (d_rnn,), ("rnn",), zeros=True, dtype=dtype)
    reg.add(f"{p}/w_i", (d_rnn, d_rnn), ("rnn", "rnn2"), dtype=dtype, scale=1e-2)
    reg.add(f"{p}/b_i", (d_rnn,), ("rnn",), zeros=True, dtype=dtype)
    reg.add(f"{p}/lam", (d_rnn,), ("rnn",), zeros=True, dtype=dtype)


def _conv1d_causal(x, w, b, state=None):
    """Depthwise causal conv; x [B,T,C], w [W,C]; state [B,W-1,C] history.
    Returns (out, new conv state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[0], width - 1, x.shape[2], dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + t] * w[i]
    return out + b, xp[:, -(width - 1):]


def _rglru_gates(p, u):
    r = torch.sigmoid(u @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(u @ p["w_i"] + p["b_i"])
    a = torch.exp((-RG_C * F.softplus(p["lam"]) * r).float())
    gated = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (i * u).float()
    return a, gated


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, by doubling:
    after the step of offset o each position holds the combine of the
    ``2 o`` elements ending at it."""
    t = a.shape[1]
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_block(p, x, h0=None, conv_state=None):
    """x: [B,T,D] -> (out [B,T,D], (h_last [B,d_rnn], conv_state))."""
    u, conv_state_new = _conv1d_causal(x @ p["w_x"], p["conv_w"], p["conv_b"], conv_state)
    a, gated = _rglru_gates(p, u)
    if h0 is not None:  # fold the carried state into step 0
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0.float())[:, None], gated[:, 1:]], dim=1)
    h = linear_scan(a, gated).to(x.dtype)
    out = (h * gelu(x @ p["w_gate"])) @ p["w_out"]
    return out, (h[:, -1], conv_state_new)


def rglru_decode(p, x1, h, conv_state):
    """One-token step. x1 [B,1,D]; h [B,d_rnn]; conv_state [B,W-1,d_rnn]."""
    u, conv_state_new = _conv1d_causal(x1 @ p["w_x"], p["conv_w"], p["conv_b"], conv_state)
    a, gated = _rglru_gates(p, u)
    h_new = a[:, 0] * h.float() + gated[:, 0]
    out = (h_new[:, None].to(x1.dtype) * gelu(x1 @ p["w_gate"])) @ p["w_out"]
    return out, (h_new, conv_state_new)
