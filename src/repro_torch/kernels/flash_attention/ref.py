"""Plain PyTorch version of causal flash attention."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -2.0**30


def flash_attention_ref(q, k, v):
    """q,k,v: [BH, S, D]; causal softmax attention in float32, returned in
    q's dtype.  Materialises the [BH, S, S] scores."""
    s, d = q.shape[1], q.shape[2]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / np.sqrt(d)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    logits = torch.where(mask[None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)
