"""Gradient compression with error feedback (distributed-optimization trick).

Compressing the gradient all-reduce to bf16 or int8 with error feedback
(Seide et al. '14, Karimireddy et al. '19) cuts wire bytes 2-4x while
keeping convergence: the quantization residual is carried into the next
step, so the compounded error stays bounded.

``compressed_grads`` quantizes and dequantizes with error feedback, as the
reference does; in the train step it runs before the optimizer.  The int8
scale is max|g| / 127 (floored at 1e-12 / 127) and rounding is half to even
(``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def init_error_state(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()}


def _quantize(g: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return g.to(torch.bfloat16).float()
    if mode == "int8":
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.float() * scale
    raise ValueError(mode)


def compressed_grads(grads: Dict, err: Dict, mode: str = "bf16") -> Tuple[Dict, Dict]:
    """Returns (dequantized grads as reduced on the wire, new error state)."""
    out, new_err = {}, {}
    for k, g in grads.items():
        g = g.float() + err[k]  # error feedback
        q = _quantize(g, mode)
        out[k] = q
        new_err[k] = g - q
    return out, new_err


def wire_bytes_saved(params: Dict, mode: str) -> int:
    """Bytes saved per gradient reduce vs float32."""
    total = sum(int(v.numel()) for v in params.values())
    per = {"bf16": 2, "int8": 1}[mode]
    return total * (4 - per)
