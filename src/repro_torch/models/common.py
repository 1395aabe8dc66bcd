"""Shared LM building blocks, as plain functions on tensors.

Parameters live in flat dicts keyed by slash paths ("blocks/L0/attn/wq"),
laid out as the reference keeps them: the parameters of each position of
the layer pattern are stacked along a leading axis of pattern blocks under
``blocks/L{i}/`` (remainder layers unstacked under ``rem{j}/``; Whisper's
under ``enc/`` and ``dec/``), so the reference's parameters cross over
array for array (``repro_torch.convert``).  The reference's mesh
hints (``shard_hint``, ``act_hint``, ``batch_axes``) have no meaning on one
card and have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Registry:
    """Collects parameters during init, drawn from one ``torch.Generator``.

    The scales are the reference's (``Registry.add``): normal draws times
    ``1/sqrt(shape[-2])`` (``1/sqrt(shape[-1])`` for a vector) unless
    ``scale`` is given, zeros for gains, biases, ``w0`` and ``u``.  With
    ``layers`` > 0 every parameter is stacked along a leading axis of that
    length; the scale follows the per-layer shape.
    """

    def __init__(self, generator: torch.Generator, device: torch.device, layers: int = 0):
        self.params: Params = {}
        self.generator = generator
        self.device = device
        self.lead: Tuple[int, ...] = (layers,) if layers else ()

    def add(self, path: str, shape, scale=None, dtype=torch.float32, zeros=False) -> torch.Tensor:
        full = self.lead + tuple(shape)
        if zeros:
            v = torch.zeros(full, dtype=dtype, device=self.device)
        else:
            scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
            v = torch.randn(full, generator=self.generator, device=self.device, dtype=torch.float32)
            v = (v * float(scale)).to(dtype)
        self.params[path] = v
        return v


def sub(params: Params, prefix: str) -> Params:
    """View of a flat dict under a path prefix (strips the prefix)."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in params.items() if k.startswith(p)}


def rms_norm(x, gamma, eps=1e-5):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embeddings, half-split rotation; x: [..., S, H, Dh],
    positions: [..., S]."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = torch.exp(-np.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int) -> torch.Tensor:
    """[seq_len, d_model] float32: sines then cosines, computed in float64
    as the reference does and rounded once."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d_model)
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32))


def gelu(x):
    """GELU in its tanh form, the reference's default."""
    return F.gelu(x, approximate="tanh")


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w1, b1, w2, b2):
    return gelu(x @ w1 + b1) @ w2 + b2


def cross_entropy_loss(logits, labels, mask=None, z_loss: float = 0.0):
    """Mean token cross entropy in float32, optional masking and z-loss.
    The float32 logits are the one copy that the backward keeps
    (logsumexp saves its input; the gather saves only the labels)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    loss = lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is None:
        return loss.mean()
    mask = mask.float()
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
