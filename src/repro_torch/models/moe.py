"""Mixture-of-experts FFN with sort-based capacity dispatch.

The two dispatches of the reference:

* ``dispatch="sorted"`` (the default): within each sequence, token slots
  are sorted by expert id and packed into a static [E, C, d] buffer
  (C = ceil(S*k/E * capacity_factor)); slots past an expert's capacity go
  to a trash row and are dropped; the expert FFN is one batched product
  over the experts.
* ``dispatch="dense"`` (the oracle): every token through every expert,
  combined with the routing weights.

Routing drops and combines exactly as the reference does:
``select_top_k`` breaks ties by the lower expert index (``lax.top_k``'s
order, which ``torch.topk`` does not promise: bf16 router logits do tie),
the sort by expert is stable, and a slot's rank inside its expert is its index minus
the expert's first slot.  The expert products are plain ``torch.einsum``,
as the reference leaves them to XLA outside any kernel.

``routing_tape`` pins the router across two runs of one model, so that two
paths whose router logits differ by rounding can be held to rounding.

Dispatch is local to the batch dim, so under a mesh (DTensor activations)
the routing, the sort and the packing run on each rank's batch shard
(the batch over "data", replicated over "model"), and only the packed
[B, E, C, D] buffer meets the expert weights as a DTensor: EP over "model"
when the expert count divides it (the reference's ``_buf_hint`` and
``_h_hint``), else the expert-ff width.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .common import batch_axes, like, local_part, shard_hint


def _buf_hint(x):
    return shard_hint(x, batch_axes(), "model", None, None)


def _h_hint(x):
    return shard_hint(x, batch_axes(), "model", None, "model")


def select_top_k(probs, k: int):
    """The k largest along the last axis, largest first and, among equal
    values, the lower index first (the reference's ``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


_TAPE = None  # the active routing_tape: (choices made, choices to replay or None)


@contextlib.contextmanager
def routing_tape(replay: list | None = None):
    """Inside the block every ``moe_ffn`` call appends its expert choice
    (the [B, S, k] top-k indices) to the list this yields.  Given ``replay``
    (such a list from an earlier block), the call at position i takes the
    experts of ``replay[i]`` instead of its own top k; its gate weights stay
    its own router probabilities at those experts, renormalised.  A near-tie
    that rounding flips then routes both runs' tokens alike."""
    global _TAPE
    outer, _TAPE = _TAPE, ([], replay)
    try:
        yield _TAPE[0]
    finally:
        _TAPE = outer


def _route(probs, k: int):
    if _TAPE is None:
        return select_top_k(probs, k)
    made, replay = _TAPE
    if replay is None:
        vals, idx = select_top_k(probs, k)
    else:
        idx = replay[len(made)].to(probs.device)
        vals = torch.gather(probs, -1, idx)
    made.append(idx)
    return vals, idx


def moe_ffn(x, w_router, w_gate, w_up, w_down, *, top_k: int, capacity_factor: float = 1.25,
            dispatch: str = "sorted"):
    """x: [B,S,D]; w_router: [D,E]; w_gate/up: [E,D,F]; w_down: [E,F,D]."""
    b, s, d = x.shape
    e = w_router.shape[1]
    if dispatch == "sorted":  # per-sequence dispatch: the batch shard stays whole on each rank
        x = shard_hint(x, batch_axes(), None, None)
    probs = torch.softmax((x @ w_router).float(), dim=-1)
    if dispatch == "sorted":
        x_all, x = x, local_part(x)
        probs = local_part(shard_hint(probs, batch_axes(), None, None))
        b = x.shape[0]
    gate_w, gate_i = _route(probs, top_k)  # [B,S,k]
    gate_w = (gate_w / gate_w.sum(-1, keepdim=True)).to(x.dtype)

    if dispatch == "dense":
        h = F.silu(torch.einsum("bsd,edf->bsef", x, w_gate)) * torch.einsum("bsd,edf->bsef", x, w_up)
        y_all = torch.einsum("bsef,efd->bsed", h, w_down)  # [B,S,E,D]
        comb = torch.einsum("bsk,bske->bse", gate_w, F.one_hot(gate_i, e).to(x.dtype))
        return torch.einsum("bse,bsed->bsd", comb, y_all)
    if dispatch != "sorted":
        raise ValueError(f"dispatch must be 'sorted' or 'dense', got {dispatch!r}")

    # ---- sorted dispatch, local per sequence
    cap = int(np.ceil(s * top_k / e * capacity_factor))
    n_slots = s * top_k
    dev = x.device
    flat_e = gate_i.reshape(b, n_slots)
    flat_t = torch.arange(s, device=dev).repeat_interleave(top_k)  # token of each slot
    flat_w = gate_w.reshape(b, n_slots)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]  # [B, n_slots]
    sw = torch.gather(flat_w, 1, order)
    # rank within an expert's group = slot index - the group's first slot
    starts = torch.searchsorted(se, torch.arange(e, device=dev).expand(b, e).contiguous())
    rank = torch.arange(n_slots, device=dev)[None, :] - torch.gather(starts, 1, se)
    keep = rank < cap  # overflow drops
    dest = torch.where(keep, se * cap + rank, e * cap)  # e*cap = the trash row
    rows = torch.arange(b, device=dev)[:, None]
    xs = x[rows, st]  # [B, n_slots, D]
    buf = torch.zeros(b, e * cap + 1, d, dtype=x.dtype, device=dev)
    buf[rows, dest] = xs * keep[..., None].to(x.dtype)
    buf = _buf_hint(like(buf[:, :-1].reshape(b, e, cap, d), x_all, (x_all.shape[0], e, cap, d)))
    h = F.silu(_h_hint(torch.einsum("becd,edf->becf", buf, w_gate))) * torch.einsum("becd,edf->becf", buf, w_up)
    y = _buf_hint(torch.einsum("becf,efd->becd", h, w_down))
    y = local_part(shard_hint(y, batch_axes(), None, None, None)).reshape(b, e * cap, d)
    yg = y[rows, torch.clamp(dest, max=e * cap - 1)] * (keep[..., None] * sw[..., None]).to(x.dtype)
    out = torch.zeros(b, s, d, dtype=x.dtype, device=dev)
    return like(out.index_put_((rows.expand(b, n_slots), st), yg, accumulate=True), x_all, x_all.shape)

