"""Plain PyTorch version of the segmented batched block GEMM."""
from __future__ import annotations

import torch


def block_sparse_matmul_ref(
    lhs: torch.Tensor, rhs: torch.Tensor, out_idx, num_out: int
) -> torch.Tensor:
    """out[o] = sum_{p: out_idx[p]==o} lhs[p] @ rhs[p], zeros where no pair.

    Products in the accumulation type (f64 for f64, else f32), summed into
    zeros with ``index_add_``, cast back to the input type.
    """
    acc = torch.float64 if lhs.dtype == torch.float64 else torch.float32
    prod = torch.einsum("pmk,pkn->pmn", lhs.to(acc), rhs.to(acc))
    idx = torch.as_tensor(out_idx, device=lhs.device).to(torch.long)
    out = torch.zeros((num_out, lhs.shape[1], rhs.shape[2]), dtype=acc, device=lhs.device)
    out.index_add_(0, idx, prod)
    return out.to(lhs.dtype)
