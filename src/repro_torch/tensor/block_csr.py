"""Sparse-sparse contraction as one batched block-sparse GEMM.

The paper's sparse-sparse algorithm stores whole tensors as one distributed
element-sparse CTF tensor and pre-computes the output sparsity from the
quantum numbers.  Here the sparsity stays at *block* granularity: every
quantum-number block is matricized and zero-padded into one packed batch per
operand, the (lhs, rhs) -> out pair table comes from the charges, and one
launch of the segmented block GEMM (``kernels/block_gemm``) does the work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .blocksparse import BlockKey, BlockSparseTensor


def pack_blocks(
    t: BlockSparseTensor,
    keys: Sequence[BlockKey],
    keep: Sequence[int],
    ax: Sequence[int],
    rdim: int,
    cdim: int,
    keep_first: bool,
) -> torch.Tensor:
    """Matricize + zero-pad blocks into one [len(keys), rdim, cdim] batch.

    ``keep_first`` puts the kept modes on rows (lhs layout) vs the contracted
    modes on rows (rhs layout).  Entries beyond each block stay zero, which
    the kernel relies on (it skips them by the layout's per-pair extents).
    """
    perm = list(keep) + list(ax) if keep_first else list(ax) + list(keep)
    n_rows = len(keep) if keep_first else len(ax)
    out = torch.zeros((len(keys), rdim, cdim), dtype=t.dtype, device=t.device)
    for n, k in enumerate(keys):
        blk = t.blocks[k].permute(perm)
        r = int(np.prod(blk.shape[:n_rows]))
        c = int(np.prod(blk.shape[n_rows:]))
        out[n, :r, :c] = blk.reshape(r, c)
    return out


def contract_block_csr(
    a: BlockSparseTensor,
    b: BlockSparseTensor,
    axes: Tuple[Sequence[int], Sequence[int]],
    *,
    use_kernel: bool = True,
) -> BlockSparseTensor:
    """Contract via one batched block-sparse GEMM (sparse-sparse analogue).

    The csr backend of ``dist.ContractionEngine`` on a fresh plan: zero
    padding is exact for GEMMs, so the result equals the list algorithm
    (``contract``) block for block to rounding.
    """
    from ..dist.engine import ContractionEngine  # lazy: dist builds on tensor

    return ContractionEngine("csr", use_kernel=use_kernel)(a, b, axes)
