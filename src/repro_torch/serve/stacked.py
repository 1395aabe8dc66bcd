"""Stacked block-sparse tensors: a leading problem axis over shared structure.

The multi-problem solver batches B DMRG problems that share one charge
structure -- same indices, same block keys, different block *values* (a
J/h parameter sweep) -- by stacking each block along a new leading axis: a
"stacked" ``BlockSparseTensor`` carries ``[B, ...]`` blocks while its
indices still describe the per-problem structure.

Plans read only indices, charges and block keys, so a stacked tensor shares
its plans with single-problem runs.  The engine's batched backend, the
fused environment core and the planned SVD take stacked blocks as they come
(``dist/batch.py``, ``dist/envcore.py``, ``dist/decomp.py``): the reference
runs its single-problem bodies under ``jax.vmap``; the port's block GEMM
is a ctypes kernel that cannot be vmapped, so the problem axis is folded
into the kernel's pair axis instead -- one launch per bucket for the whole
batch.

What does not compose is anything with per-problem *scalars* (norms, inner
products, scaling): those return and take ``[B]`` tensors here
(``binner``, ``bnorm``, ``bscale``, ``bselect``, ``blincomb``).  The
power-of-two pads never touch the problem axis (``pad_stacked``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..dist.batch import batch_shape, pad_block_sparse, unpad_block_sparse
from ..dist.engine import ContractionEngine
from ..tensor.blocksparse import BlockKey, BlockSparseTensor

# Graphs a serving process keeps: a warmed group replays every structure of
# a whole solve per slot, more than the single-run cache's LRU bound holds
# (a cyclic walk over more structures than the bound misses every time).
SERVE_MAX_GRAPHS = 8192

# the dist layer's power-of-two pads, which leave a leading problem axis alone
pad_stacked = pad_block_sparse
unpad_stacked = unpad_block_sparse


# ----------------------------------------------------------- stack / unstack
def stack_tensors(ts: Sequence[BlockSparseTensor]) -> BlockSparseTensor:
    """Stack B same-structure tensors into one stacked tensor ([B, ...] blocks).

    All inputs must agree on indices, charge and block keys -- the scheduler
    guarantees this by grouping requests by structure signature; a mismatch
    here means a grouping bug, so it raises instead of broadcasting.
    """
    t0 = ts[0]
    keys = sorted(t0.blocks)
    for t in ts[1:]:
        if t.indices != t0.indices or t.charge != t0.charge:
            raise ValueError("stack_tensors: mismatched index structure")
        if sorted(t.blocks) != keys:
            raise ValueError("stack_tensors: mismatched block keys")
    blocks = {k: torch.stack([t.blocks[k] for t in ts]) for k in keys}
    return BlockSparseTensor(t0.indices, blocks, t0.charge)


def unstack_tensor(t: BlockSparseTensor, b: int) -> BlockSparseTensor:
    """Problem ``b`` of a stacked tensor (views of its blocks)."""
    return BlockSparseTensor(t.indices, {k: blk[b] for k, blk in t.blocks.items()}, t.charge)


def broadcast_tensor(t: BlockSparseTensor, B: int) -> BlockSparseTensor:
    """Replicate an unbatched tensor across B problems (views, no copy)."""
    blocks = {k: blk.unsqueeze(0).expand((B,) + tuple(blk.shape)) for k, blk in t.blocks.items()}
    return BlockSparseTensor(t.indices, blocks, t.charge)


def batch_size(t: BlockSparseTensor) -> int:
    lead = batch_shape(t)
    if not t.blocks:
        raise ValueError("batch_size of a tensor with no blocks")
    if len(lead) != 1:
        raise ValueError(f"not a stacked tensor: leading axes {lead}")
    return lead[0]


# ------------------------------------------------- per-problem scalar algebra
def _to_device(c, device: torch.device) -> torch.Tensor:
    """A host array (or tensor) on ``device``.  A host array crosses with a
    non-blocking copy: from pageable memory the copy is staged before the
    call returns, so nothing waits for the card's queue (a blocking copy
    would sync the host with the card at every per-problem scale)."""
    return torch.as_tensor(c).to(device, non_blocking=True)


def _coef(c, blk: torch.Tensor) -> torch.Tensor:
    """A [B] coefficient vector, as a tensor on ``blk``'s device in its
    type, shaped to broadcast over ``blk``'s trailing axes."""
    return _to_device(c, blk.device).to(blk.dtype).reshape((-1,) + (1,) * (blk.dim() - 1))


def binner(a: BlockSparseTensor, b: BlockSparseTensor) -> torch.Tensor:
    """Per-problem <a|b>: a [B] tensor, summing over shared block keys only
    (the stacked mirror of ``BlockSparseTensor.inner``)."""
    acc = None
    for k, blk in a.blocks.items():
        other = b.blocks.get(k)
        if other is None:
            continue
        part = torch.sum(torch.conj(blk) * other, dim=tuple(range(1, blk.dim())))
        acc = part if acc is None else acc + part
    return acc


def bnorm_sq(t: BlockSparseTensor) -> torch.Tensor:
    acc = None
    for blk in t.blocks.values():
        part = torch.sum(torch.abs(blk) ** 2, dim=tuple(range(1, blk.dim())))
        acc = part if acc is None else acc + part
    return torch.real(acc)


def bnorm(t: BlockSparseTensor) -> torch.Tensor:
    """Per-problem Frobenius norm, a [B] tensor."""
    return torch.sqrt(bnorm_sq(t))


def bscale(t: BlockSparseTensor, c) -> BlockSparseTensor:
    """Scale each problem by its own coefficient (``c``: [B], a tensor or
    host array)."""
    return BlockSparseTensor(t.indices, {k: blk * _coef(c, blk) for k, blk in t.blocks.items()}, t.charge)


def bselect(mask, a: BlockSparseTensor, b: BlockSparseTensor) -> BlockSparseTensor:
    """Per-problem select: problem i takes a's slice where mask[i], else b's.

    Missing blocks on either side count as zeros (like ``__add__``'s union
    semantics), so tensors produced by different pipelines can be merged.
    """
    if a.indices != b.indices or a.charge != b.charge:
        raise ValueError("bselect of tensors of different structure")
    blocks: Dict[BlockKey, torch.Tensor] = {}
    for k in set(a.blocks) | set(b.blocks):
        ab, bb = a.blocks.get(k), b.blocks.get(k)
        if ab is None:
            ab = torch.zeros_like(bb)
        if bb is None:
            bb = torch.zeros_like(ab)
        m = _to_device(mask, ab.device).to(torch.bool).reshape((-1,) + (1,) * (ab.dim() - 1))
        blocks[k] = torch.where(m, ab, bb)
    return BlockSparseTensor(a.indices, blocks, a.charge)


def blincomb(ts: Sequence[BlockSparseTensor], coeffs) -> BlockSparseTensor:
    """sum_j coeffs[:, j] * ts[j], per problem (``coeffs``: [B, len(ts)])."""
    coeffs = torch.as_tensor(coeffs)
    out = bscale(ts[0], coeffs[:, 0])
    for j in range(1, len(ts)):
        out = out + bscale(ts[j], coeffs[:, j])
    return out


# -------------------------------------------------------------- StackedOps
class StackedOps:
    """The stacked pipelines of a serving process, on one batched engine.

    One instance per serving process: its ``ContractionEngine``
    (``backend="batched"``, ``use_kernel=True``) holds the plan caches and
    the CUDA graph cache, which must outlive each batch so that steady-state
    requests replay captured graphs.  ``contract`` runs eagerly (one block
    GEMM launch per bucket, the problem axis folded into its pair axis);
    ``matvec_fn`` and ``env_update`` replay one CUDA graph per (padded
    structure, batch size) through the engine's graph cache.

    ``retraces`` counts what the reference counts as (re)traces of its
    vmapped bodies: on the card, every capture of a matvec or environment
    graph (a new padded structure or batch size, or a recapture after a
    static-buffer growth or an eviction); on the CPU, every first eager run
    of such a (body, padded structure, batch size) key.  The graph cache
    counts both as ``graph_captures``.  The serve CLI's ``--check`` asserts
    it stays zero after warmup.  The theta contraction and the SVD run
    eagerly, so they count nothing.
    """

    def __init__(self, engine: ContractionEngine | None = None):
        self.engine = engine if engine is not None else ContractionEngine(backend="batched")
        if self.engine.backend != "batched":
            raise ValueError(f"StackedOps runs on the batched backend, not {self.engine.backend!r}")
        self.engine.graphs.max_graphs = SERVE_MAX_GRAPHS

    @property
    def retraces(self) -> int:
        return self.engine.graphs.captures

    def contract(self, a: BlockSparseTensor, b: BlockSparseTensor, axes) -> BlockSparseTensor:
        return self.engine(a, b, axes)

    def matvec_fn(self, A, Wj, Wj1, B):
        """Batched Davidson matvec closure over fixed stacked operands."""
        return self.engine.matvec_fn(A, Wj, Wj1, B, jit=True)

    def env_update(self, side: str, env, T, W, *, mpo_padded=None) -> BlockSparseTensor:
        """Fused env update of every problem (pads and plans inside)."""
        update = self.engine.env_update_left if side == "left" else self.engine.env_update_right
        return update(env, T, W, mpo_padded=mpo_padded)

    def stats(self) -> Dict:
        return {"retraces": self.retraces, "compiled_fns": len(self.engine.graphs)}
