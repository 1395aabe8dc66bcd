"""Batched block-contraction execution and power-of-two shape bucketing.

Two pieces of the same idea — make the block structure *regular* so the card
sees few large launches instead of many small ones (Menczer et al.,
arXiv:2407.07411):

1. ``execute_batched`` runs a ``ContractionPlan``'s shape-bucket table
   (``plan.batched``): per bucket one stacked block GEMM over all
   same-(M, K, N) block pairs with a segment sum into the bucket's output
   slots, through ``kernels/block_gemm/ops.block_sparse_matmul`` (the
   hand-written kernel on a CUDA tensor, its plain version on the CPU).  A
   bucket has no padding inside it, so the launch passes no extents and
   the bucket's work list is built once and cached on it.

2. ``pad_block_sparse`` rounds every sector dimension up to a power of two.
   Zero padding is exact for contractions — the padded entries of every
   operand are zero, so the padded matvec equals the padding of the true
   matvec — and it quantizes the block structure, so a CUDA graph captured
   for one padded structure (``dist/graphs.py``) is replayed across the
   bonds and sweeps that share it.

Equality: buckets execute the exact per-pair products (no padding of M, K,
N), so ``execute_batched`` equals the list algorithm block for block up to
the order of accumulation (<=1e-13 on random f64 tensors,
``tests/test_torch_batch.py``).  Nothing here syncs with the host or copies
from it once the layout's tables are on the card
(``BatchedLayout.device_tables``, the buckets' work lists), so the bucket
loop can be captured into a CUDA graph.

Stacked tensors (``serve/stacked.py``): B problems of one block structure
carry ``[B, ...]`` blocks, one leading axis more than their indices have
modes.  Everything here takes them as they come: matricizing gives
``[B, r, c]``, and a bucket folds the problem axis into the block GEMM's
pair axis -- ``lhs [B*P, m, k]``, ``rhs [B*P, k, n]``, pair ``b*P + p``
writing output slot ``oi[p] + b*O`` of ``B*O`` (``ShapeBucket.folded_oi``,
still ascending) -- so one launch per bucket serves the whole batch, with
the folded work list built once per batch size on the bucket.  A pair
product of the list pieces (``execute_pairs``) is a batched ``matmul`` over
the leading axis, and the power-of-two pads never touch it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.block_gemm.ops import block_sparse_matmul
from ..tensor.blocksparse import BlockKey, BlockSparseTensor
from ..tensor.qn import Index
from . import faults
from .graphs import capturing
from .plan import ContractionPlan, ShapeBucket, _prod, bucket_dim

BlockMats = Dict[BlockKey, torch.Tensor]


def execute_pairs(plan: ContractionPlan, a_blocks: Dict, b_blocks: Dict) -> Dict:
    """Execute a plan's pair table as one ``tensordot`` per pair, into a dict.

    The list algorithm's numeric half, shared by the engine's "list"
    backend and the fused environment core (``dist/envcore.py``), so the
    order of accumulation cannot differ between them.  Stacked blocks (one
    leading problem axis) take one batched ``matmul`` per pair instead.
    """
    out: Dict = {}
    if not plan.pairs:
        return out
    n_a = len(plan.keep_a) + len(plan.ax_a)
    if next(iter(a_blocks.values())).dim() > n_a:
        product = _stacked_product(plan)
    else:
        dims = (list(plan.ax_a), list(plan.ax_b))

        def product(a, b):
            return torch.tensordot(a, b, dims=dims)

    for ka, kb, kc in plan.pairs:
        piece = product(a_blocks[ka], b_blocks[kb])
        out[kc] = out[kc] + piece if kc in out else piece
    return out


def _stacked_product(plan: ContractionPlan):
    """The pair product on stacked blocks: ``tensordot`` over the plan's axes
    for each problem of the leading axis, as one batched ``matmul``."""
    perm_a = (0,) + tuple(1 + i for i in plan.keep_a + plan.ax_a)
    perm_b = (0,) + tuple(1 + i for i in plan.ax_b + plan.keep_b)

    def product(a, b):
        keep_a = tuple(a.shape[1 + i] for i in plan.keep_a)
        keep_b = tuple(b.shape[1 + i] for i in plan.keep_b)
        m = a.permute(perm_a).reshape(a.shape[0], _prod(keep_a), -1)
        n = b.permute(perm_b).reshape(b.shape[0], -1, _prod(keep_b))
        return torch.matmul(m, n).reshape((a.shape[0],) + keep_a + keep_b)

    return product


def batch_shape(t: BlockSparseTensor) -> Tuple[int, ...]:
    """The leading problem axes of ``t``'s blocks: ``()`` for one problem,
    ``(B,)`` for a stacked tensor (``serve/stacked.py``)."""
    for blk in t.blocks.values():
        return tuple(blk.shape[: blk.dim() - t.ndim])
    return ()


def _matricize(t, first: Tuple[int, ...], second: Tuple[int, ...]) -> BlockMats:
    """2-D form of every block, rows ``first`` and columns ``second``;
    leading axes beyond the modes (a stacked tensor's problem axis) stay in
    front, so a stacked block gives ``[B, r, c]``."""
    blocks = t.blocks if isinstance(t, BlockSparseTensor) else t
    out: BlockMats = {}
    for key, blk in blocks.items():
        lead = blk.dim() - len(first) - len(second)
        perm = tuple(range(lead)) + tuple(lead + i for i in first + second)
        r = _prod(blk.shape[lead + i] for i in first)
        out[key] = blk.permute(perm).reshape(tuple(blk.shape[:lead]) + (r, -1))
    return out


def matricize_lhs(t, keep: Tuple[int, ...], ax: Tuple[int, ...]) -> BlockMats:
    """2-D (kept rows, contracted cols) form of every block of ``t``.

    Depends only on the contraction's static axes, not on the partner's
    block structure, so for the fixed Davidson operands (A, W_j, W_{j+1}, B)
    it is computed once per solve, not inside every matvec.  ``t`` may be a
    ``BlockSparseTensor`` or a bare key -> tensor dict.
    """
    return _matricize(t, tuple(keep), tuple(ax))


def matricize_rhs(t, keep: Tuple[int, ...], ax: Tuple[int, ...]) -> BlockMats:
    """2-D (contracted rows, kept cols) form of every block of ``t``."""
    return _matricize(t, tuple(ax), tuple(keep))


def bucket_operands(bucket: ShapeBucket, a_mats: BlockMats, b_mats: BlockMats):
    """The block GEMM's ``(lhs [P, m, k], rhs [P, k, n])`` of one bucket: its
    blocks stacked in pair order (``li``, ``ri``), a block that serves
    several pairs once per pair — one copy per operand, where stacking the
    unique blocks and gathering them would be two.  Stacked ``[B, r, c]``
    blocks fold into the pair axis b-major: ``lhs [B*P, m, k]``, ``rhs
    [B*P, k, n]`` (one copy per operand all the same)."""
    a_list = [a_mats[bucket.a_keys[i]] for i in bucket.li]
    b_list = [b_mats[bucket.b_keys[i]] for i in bucket.ri]
    if a_list[0].dim() == 2:
        return torch.stack(a_list), torch.stack(b_list)
    return (torch.stack(a_list, dim=1).flatten(0, 1), torch.stack(b_list, dim=1).flatten(0, 1))


def execute_batched_blocks(
    plan: ContractionPlan, a_mats: BlockMats, b_mats: BlockMats, *, use_kernel: bool = True, gemm_fn=None
) -> Dict[BlockKey, torch.Tensor]:
    """The bucket loop on pre-matricized blocks, returning output blocks.

    Each bucket is one ``block_sparse_matmul`` launch with the bucket's
    cached work list; buckets that feed the same output block add up here.
    Stacked ``[B, r, c]`` blocks run the same loop with the problem axis
    folded into each bucket's pair axis (the bucket's folded work list and
    output slots), still one launch per bucket, and return ``[B, ...]``
    blocks.

    ``gemm_fn(lhs, rhs, oi, num_out)`` replaces the bucket's launch, with
    ``oi`` the bucket's host (numpy) output slots: ``dist/spmd.py`` passes
    its split GEMM here, so one bucket table drives both the single-process
    and the SPMD execution (the reference's hook, ``dist/batch.py``).
    """
    layout = plan.batched
    first = next(iter(a_mats.values()))
    batch = first.shape[0] if first.dim() == 3 else 1
    lead = (batch,) if first.dim() == 3 else ()
    if gemm_fn is None:
        tables = layout.device_tables(first.device, batch)
    else:
        tables = [b.oi if batch == 1 else b.folded_oi(batch) for b in layout.buckets]
    out_acc: Dict[BlockKey, torch.Tensor] = {}
    for bucket, oi in zip(layout.buckets, tables):
        lhs, rhs = bucket_operands(bucket, a_mats, b_mats)
        O = len(bucket.out_keys)
        if gemm_fn is None:
            out = block_sparse_matmul(lhs, rhs, oi, batch * O, work=bucket.folded_work(batch), use_kernel=use_kernel)
        else:
            out = gemm_fn(lhs, rhs, oi, batch * O)
        out = out.view(lead + (O, bucket.m, bucket.n))
        for slot, kc in enumerate(bucket.out_keys):
            piece = out[..., slot, :, :]
            prev = out_acc.get(kc)
            out_acc[kc] = piece if prev is None else prev + piece
    return {kc: mat.reshape(lead + plan.out_block_shape(kc)) for kc, mat in out_acc.items()}


def execute_batched(
    plan: ContractionPlan,
    a: BlockSparseTensor,
    b: BlockSparseTensor,
    *,
    a_mats: Optional[BlockMats] = None,
    b_mats: Optional[BlockMats] = None,
    use_kernel: bool = True,
    gemm_fn=None,
) -> BlockSparseTensor:
    """Execute ``plan`` bucket by bucket as stacked block GEMMs.

    ``a_mats`` / ``b_mats`` are optional pre-matricized operand blocks
    (``matricize_lhs`` / ``matricize_rhs``) for operands fixed across many
    calls; live operands are matricized here.  ``gemm_fn`` swaps the
    per-bucket GEMM (see ``execute_batched_blocks``).
    """
    if not plan.pairs:
        return BlockSparseTensor(plan.out_indices, {}, plan.out_charge)
    if a_mats is None:
        a_mats = matricize_lhs(a, plan.keep_a, plan.ax_a)
    if b_mats is None:
        b_mats = matricize_rhs(b, plan.keep_b, plan.ax_b)
    blocks = execute_batched_blocks(plan, a_mats, b_mats, use_kernel=use_kernel, gemm_fn=gemm_fn)
    # fault point: NaN-poison one output block, a bad GEMM on a flaky card.
    # Skipped inside a CUDA graph capture (the counterpart of the
    # reference's tracing guard): a poisoned capture would replay the NaN
    # long after the fault, so under jit_matvec it fires on eager calls only
    k0 = next(iter(blocks), None)
    if k0 is not None and not capturing(blocks[k0]) and faults.fire("batch.gemm_nan") is not None:
        blocks[k0] = torch.full_like(blocks[k0], float("nan"))
    return BlockSparseTensor(plan.out_indices, blocks, plan.out_charge)


# --------------------------------------------------------- power-of-two pads
def pad_index(ix: Index) -> Index:
    """Same charges and flow, sector dims rounded up to powers of two."""
    return Index(tuple((q, bucket_dim(d)) for q, d in ix.sectors), ix.flow, ix.name)


def pad_block_sparse(t: BlockSparseTensor) -> BlockSparseTensor:
    """Zero-pad every block so that all sector dims are powers of two.

    Same charges, flows and block keys; only the degeneracies grow.  Both
    members of every contracted index pair pad identically, and the padded
    entries are zero, so any contraction of padded tensors equals the
    padding of the unpadded contraction exactly.  The leading problem axis
    of a stacked tensor is never padded.
    """
    out = BlockSparseTensor(tuple(pad_index(ix) for ix in t.indices), {}, t.charge)
    for k, blk in t.blocks.items():
        tgt = out.block_shape(k)
        if tgt == tuple(blk.shape[blk.dim() - len(tgt):]):
            out.blocks[k] = blk
        else:
            widths = [w for ts, s in zip(reversed(tgt), reversed(blk.shape)) for w in (0, ts - s)]
            out.blocks[k] = F.pad(blk, widths)
    return out


def unpad_block_sparse(t: BlockSparseTensor, indices: Tuple[Index, ...]) -> BlockSparseTensor:
    """Slice a padded tensor back to the given (original) index structure;
    a stacked tensor keeps its leading problem axis whole."""
    out = BlockSparseTensor(indices, {}, t.charge)
    for k, blk in t.blocks.items():
        tgt = out.block_shape(k)
        same = tgt == tuple(blk.shape[blk.dim() - len(tgt):])
        out.blocks[k] = blk if same else blk[(Ellipsis,) + tuple(slice(0, s) for s in tgt)]
    return out
