"""Shared LM building blocks, as plain functions on tensors.

Parameters live in flat dicts keyed by slash paths ("blocks/L0/attn/wq"),
laid out as the reference keeps them: the parameters of each position of
the layer pattern are stacked along a leading axis of pattern blocks under
``blocks/L{i}/`` (remainder layers unstacked under ``rem{j}/``; Whisper's
under ``enc/`` and ``dec/``), so the reference's parameters cross over
array for array (``repro_torch.convert``).  A parallel dict maps each path
to a tuple of *logical axis names* (``Registry.axes``, ``models.param_axes``),
which ``launch/sharding.py`` resolves to DTensor placements on a mesh (TP
over "model", FSDP over "data"); stacked entries carry a leading "layers".

The reference's mesh hints (``shard_hint``, ``act_hint``, ``batch_axes``)
are kept at its sites.  On a plain tensor they do nothing.  On a DTensor
they redistribute it to the placements that the reference's resolution
rule gives (each named axis kept only if the mesh has it and no earlier
dim took it, then leading axes dropped until the product divides the dim),
which is where XLA's ``with_sharding_constraint`` puts the reference's
arrays.  ``mesh_scope`` lets the plain tensors that a model makes inside
(positions, masks, zero pads) meet DTensors as replicated ones.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.sharded import from_local_like, is_dtensor

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple[str, ...]]

# mesh axes carrying the batch dim of activations; "model" is left for TP
BATCH_AXES = ("pod", "data")


def batch_axes():
    return BATCH_AXES

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Registry:
    """Collects parameters during init, drawn from one ``torch.Generator``.

    The scales are the reference's (``Registry.add``): normal draws times
    ``1/sqrt(shape[-2])`` (``1/sqrt(shape[-1])`` for a vector) unless
    ``scale`` is given, zeros for gains, biases, ``w0`` and ``u``.  With
    ``layers`` > 0 every parameter is stacked along a leading axis of that
    length; the scale follows the per-layer shape, and the logical axes get
    a leading "layers".  On the meta device nothing is drawn or allocated
    (``generator`` may be None): shapes and axes only.
    """

    def __init__(self, generator, device: torch.device, layers: int = 0):
        self.params: Params = {}
        self.axes: Axes = {}
        self.generator = generator
        self.device = torch.device(device)
        self.lead: Tuple[int, ...] = (layers,) if layers else ()

    def add(self, path: str, shape, axes, scale=None, dtype=torch.float32, zeros=False) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{path}: shape {tuple(shape)} and axes {tuple(axes)} differ in length")
        full = self.lead + tuple(shape)
        self.axes[path] = ("layers",) * len(self.lead) + tuple(axes)
        if self.device.type == "meta":
            v = torch.empty(full, dtype=dtype, device=self.device)
        elif zeros:
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


def mesh_scope(tensors):
    """A context for a model call on ``tensors`` (a dict or an iterable):
    when any is a DTensor, the plain tensors that the model makes inside
    take part as replicated DTensors (``implicit_replication``); else
    nothing."""
    values = tensors.values() if isinstance(tensors, dict) else tensors
    return _implicit_replication() if any(is_dtensor(t) for t in values) else contextlib.nullcontext()


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``, but
    nestable: it restores the setting it found instead of clearing it."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    outer = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = outer


def resolve_hint(shape, spec, sizes: Dict[str, int]):
    """The reference's ``shard_hint`` rule: per dim, the named mesh axes
    that the mesh has and no earlier dim took, with leading ones dropped
    until their product divides the dim; None, a name or a tuple."""
    resolved = []
    used: set = set()
    for dim, names in zip(shape, spec):
        if names is None:
            resolved.append(None)
            continue
        tup = names if isinstance(names, tuple) else (names,)
        tup = tuple(n for n in tup if n in sizes and n not in used)
        while tup and dim % int(np.prod([sizes[n] for n in tup])) != 0:
            tup = tup[1:]
        used.update(tup)
        resolved.append(None if not tup else tup[0] if len(tup) == 1 else tup)
    return tuple(resolved)


def shard_hint(x, *spec):
    """The reference's sharding constraint: on a DTensor, redistribute to
    the placements of ``spec`` resolved by ``resolve_hint`` on its mesh; a
    plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from ..launch.sharding import mesh_shape, placements_for

    mesh = x.device_mesh
    placements = placements_for(resolve_hint(x.shape, spec, mesh_shape(mesh)), mesh)
    return x if tuple(x.placements) == placements else x.redistribute(mesh, placements)


def local_part(t):
    """The rank's local tensor of a DTensor (differentiable), or ``t``."""
    return t.to_local() if is_dtensor(t) else t


def like(local, ref, shape=None):
    """``local`` as a DTensor laid out as ``ref`` (its mesh and placements;
    global ``shape``, by default ``ref``'s), or ``local`` itself when
    ``ref`` is a plain tensor."""
    return from_local_like(local, ref, shape=shape) if is_dtensor(ref) else local


def whole_over(t, dim: int, parts: int):
    """``t`` with ``dim`` gathered on every mesh dim that shards it and
    does not divide ``parts``, the count that ``dim`` is about to be split
    into (a plain tensor as it is): DTensor cannot unflatten a dim sharded
    unevenly over its leading part, where XLA reshards the reference's
    arrays by itself."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    placements = tuple(Replicate() if p.is_shard(dim) and parts % mesh.size(i) else p
                       for i, p in enumerate(t.placements))
    return t if placements == tuple(t.placements) else t.redistribute(mesh, placements)


def split_heads(t, n_heads: int, head_dim: int):
    """[..., n_heads * head_dim] -> [..., n_heads, head_dim].  Under a mesh
    the feature dim may be sharded over a mesh dim that does not divide the
    heads (GQA's few KV heads, rwkv6_3b's 40): that mesh dim is gathered
    first."""
    return whole_over(t, t.dim() - 1, n_heads).reshape(*t.shape[:-1], n_heads, head_dim)


def merge_heads(t):
    """[..., n_heads, head_dim] -> [..., n_heads * head_dim], the inverse of
    ``split_heads``.  Under a mesh with a dim that does not divide the heads
    (recurrentgemma_2b's 10 over 16), the merged dim keeps its forward
    placements on the way back too: the product after it returns its
    gradient sharded over "model", which the merge's backward, a view into
    heads, could not split, so that gradient is first laid out as the
    merged dim was."""
    out = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if is_dtensor(t) and any(t.shape[-2] % n for n in t.device_mesh.shape):
        out = out.redistribute(out.device_mesh, out.placements)
    return out


def write_position(cache, slot: int, value) -> None:
    """``cache[:, slot] = value[:, 0]`` in place (cache [B, S, ...], value
    [B, 1, ...]).  A DTensor cache may hold its sequence sharded ("model"
    takes it where the batch takes "data"), where DTensor's indexing would
    gather the sequence into a copy and write the copy: so each rank writes
    its own shard, the one rank whose shard holds ``slot``, with ``value``
    laid out as the cache but for the sequence."""
    if not is_dtensor(cache):
        cache[:, slot] = value[:, 0]
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    value = value.redistribute(mesh, [Replicate() if p.is_shard(1) else p for p in cache.placements])
    lo, size = 0, cache.shape[1]  # this rank's [lo, lo + size) of the sequence: DTensor's chunks, mesh dim by mesh dim
    for i, p in enumerate(cache.placements):
        if p.is_shard(1):
            chunk, k = -(-size // mesh.size(i)), mesh.get_local_rank(i)
            lo, size = lo + min(k * chunk, size), max(0, min(chunk, size - k * chunk))
    if lo <= slot < lo + size:
        cache.to_local()[:, slot - lo] = value.to_local()[:, 0]


def act_hint(x):
    """TP layout for an up-projected activation [..., S, F]: F over "model"
    (the Megatron column-parallel layout)."""
    return shard_hint(x, *([batch_axes()] + [None] * (x.dim() - 2) + ["model"]))


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
    return (F.silu(act_hint(x @ w_gate)) * act_hint(x @ w_up)) @ w_down


def gelu_mlp(x, w1, b1, w2, b2):
    return gelu(act_hint(x @ w1 + b1)) @ w2 + b2


def cross_entropy_loss(logits, labels, mask=None, z_loss: float = 0.0, vocab: int | None = None):
    """Mean token cross entropy in float32, optional masking and z-loss,
    over the first ``vocab`` logits (all by default: the padded vocab's
    tail is cut).  The float32 logits are the one copy that the backward
    keeps (logsumexp saves its input; the gather saves only the labels).
    Logits sharded over the vocab take ``_vocab_parallel_terms``, which
    masks the tail instead of cutting the sharded dim."""
    logits = logits.float()
    if is_dtensor(logits) and any(p.is_shard(logits.dim() - 1) for p in logits.placements):
        lse, picked = _vocab_parallel_terms(logits, labels.long(), vocab)
        loss = lse - picked
    else:
        if vocab is not None:
            logits = logits[..., :vocab]
        lse = torch.logsumexp(logits, dim=-1)
        # the label's logit keeps its trailing dim until the subtraction: a
        # DTensor gather from a dim sharded another way is a masked partial
        # sum, reduced there
        loss = (lse[..., None] - torch.gather(logits, -1, labels[..., None].long()))[..., 0]
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is None:
        return loss.mean()
    mask = mask.float()
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _vocab_parallel_terms(logits, labels, vocab=None):
    """(logsumexp, the label's logit) of DTensor logits whose last (vocab)
    dim one mesh dim shards, each rank working on its own vocab slice (the
    vocab-parallel cross entropy of Megatron): a max, a sum of exponentials
    and the picked logit, each a partial result over that mesh dim made
    whole by one collective.  DTensor's own plan for the gather's backward
    gathers the whole [B, S, V] logits onto every rank."""
    from torch.distributed.tensor import DTensor, Partial

    mesh, last = logits.device_mesh, logits.dim() - 1
    vdims = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    if len(vdims) != 1 or logits.shape[last] % mesh.size(vdims[0]):
        raise ValueError(f"vocab-parallel cross entropy takes the vocab evenly on one mesh dim, got {logits.placements}")
    i = vdims[0]
    if any(p.is_partial() for p in logits.placements):  # a product's sum still pending: reduced onto the batch
        from torch.distributed.tensor import Replicate, Shard

        taken = {p.dim for p in logits.placements if p.is_shard()}
        logits = logits.redistribute(mesh, tuple(
            (Shard(0) if 0 not in taken and logits.shape[0] % mesh.size(j) == 0 else Replicate()) if p.is_partial() else p
            for j, p in enumerate(logits.placements)))
    row = tuple(logits.placements)  # a per-token result keeps the token dims' placements
    whole = _row_replicated(row, i)
    partial = lambda op: tuple(Partial(op) if j == i else p for j, p in enumerate(row))
    if tuple(labels.placements) != whole:
        labels = labels.redistribute(mesh, whole)
    xl = logits.to_local()
    n = xl.shape[-1]
    offset = mesh.get_local_rank(i) * n
    if vocab is not None and vocab < logits.shape[last]:  # the padded tail takes no probability
        cols = torch.arange(offset, offset + n, device=xl.device)
        xl = torch.where(cols < vocab, xl, torch.finfo(xl.dtype).min)
    with torch.no_grad():
        mx = DTensor.from_local(xl.amax(-1), mesh, partial("max"), run_check=False).redistribute(mesh, whole)
    sumexp = DTensor.from_local(torch.exp(xl - mx.to_local()[..., None]).sum(-1), mesh, partial("sum"), run_check=False)
    lse = torch.log(sumexp.redistribute(mesh, whole)) + mx
    lab = labels.to_local() - offset
    inside = (lab >= 0) & (lab < n)
    picked = torch.gather(xl, -1, lab.clamp(0, n - 1)[..., None])[..., 0] * inside
    picked = DTensor.from_local(picked, mesh, partial("sum"), run_check=False).redistribute(mesh, whole)
    return lse, picked


def _row_replicated(row, i):
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if j == i else p for j, p in enumerate(row))
