"""Plain PyTorch version of the RWKV6 WKV scan: the naive O(T) recurrence."""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, logw, u, state=None, *, out_dtype=None):
    """r,k,v,logw: [BH,T,N]; u: [BH,N]; state: [BH,N,N] or None (zeros).
    Returns (out [BH,T,N] in ``out_dtype``, by default r's dtype, final
    state [BH,N,N]), computed in float32 (float64 when r is float64, as
    the tests' oracle runs it):

        out_t = r_t . (S_t + u * k_t^T v_t);  S_{t+1} = diag(w_t) S_t + k_t^T v_t
    """
    bh, t, n = r.shape
    dtype = r.dtype if out_dtype is None else out_dtype
    ct = torch.promote_types(r.dtype, torch.float32)
    r, k, v, u = r.to(ct), k.to(ct), v.to(ct), u.to(ct)
    w = torch.exp(logw.to(ct))
    s = torch.zeros((bh, n, n), dtype=ct, device=r.device) if state is None else state.to(ct)
    out = torch.empty((bh, t, n), dtype=ct, device=r.device)
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        out[:, i] = torch.einsum("bn,bnm->bm", r[:, i], s + u[:, :, None] * kv)
        s = s * w[:, i, :, None] + kv
    return out.to(dtype), s
