"""Left/right environment tensors (paper Fig. 1d and Sec. II-C).

Environment index convention (bra, mpo, ket):
  A_j (left env, sites < j):  i: IN (bra bond), k: OUT (mpo bond), l: OUT (ket bond)
  B_j (right env, sites > j): i: OUT, k: IN, l: IN
so that every contraction with site/MPO/bra tensors type-checks by flow.

The contraction backend is pluggable by name through ``get_contractor``:
"list" (paper Alg. 2) and "csr" (sparse-sparse, one segmented block GEMM
per contraction on the card) run through the plan-cached
``dist.ContractionEngine``; "csr_ref" is the csr backend on the block GEMM's
plain PyTorch version; "list_unplanned" is the bare ``contract``.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from ..device import resolve_device
from ..dist.engine import ContractionEngine
from ..tensor.blocksparse import BlockSparseTensor, contract
from ..tensor.qn import IN, Index, OUT

ALGOS = ("list", "csr", "csr_ref", "list_unplanned")


def get_contractor(algo: str, device=None) -> Callable:
    """Algorithm name -> contraction callable ``fn(a, b, axes)``.

    ``device`` (``None`` means the CUDA card, raising when there is none)
    is checked here so that a run asks for the CPU explicitly; the
    contractor itself computes on whatever device its operands lie.
    """
    resolve_device(device)
    if algo in ("list", "csr"):
        return ContractionEngine(backend=algo)
    if algo == "csr_ref":
        return ContractionEngine(backend="csr", use_kernel=False)
    if algo == "list_unplanned":
        return contract
    if algo in ("dense", "batched", "auto", "planned", "dense_unplanned", "csr_unplanned"):
        raise NotImplementedError(
            f"algo={algo!r} is not ported yet: the batched backend is ROADMAP "
            f"Queue 1 #5, dense/auto and the other seed algorithms are #8"
        )
    raise ValueError(f"unknown contraction algorithm: {algo}")


def left_edge(mps_t0: BlockSparseTensor, mpo_w0: BlockSparseTensor) -> BlockSparseTensor:
    lq = mps_t0.indices[0].sectors  # ((q0, 1),)
    kq = mpo_w0.indices[0].sectors
    i = Index(lq, IN, "env_i")
    k = Index(kq, OUT, "env_k")
    l = Index(lq, OUT, "env_l")
    one = torch.ones((1, 1, 1), dtype=mps_t0.dtype, device=mps_t0.device)
    return BlockSparseTensor([i, k, l], {(0, 0, 0): one})


def right_edge(mps_tn: BlockSparseTensor, mpo_wn: BlockSparseTensor) -> BlockSparseTensor:
    rq = mps_tn.indices[2].sectors
    kq = mpo_wn.indices[3].sectors
    i = Index(rq, OUT, "env_i")
    k = Index(kq, IN, "env_k")
    l = Index(rq, IN, "env_l")
    one = torch.ones((1, 1, 1), dtype=mps_tn.dtype, device=mps_tn.device)
    return BlockSparseTensor([i, k, l], {(0, 0, 0): one})


def extend_left(A, T, W, contract_fn: Callable = contract) -> BlockSparseTensor:
    """A' = A . T_j . W_j . conj(T_j), cost O(m^3 k d) + O(m^2 k^2 d^2)."""
    bra = T.conj()
    tmp = contract_fn(A, T, ((2,), (0,)))            # (i, k, s, r)
    tmp = contract_fn(tmp, W, ((1, 2), (0, 2)))      # (i, r, so, k')
    out = contract_fn(bra, tmp, ((0, 1), (0, 2)))    # (r_bra, r_ket, k')
    return out.transpose((0, 2, 1))                  # (i', k', l')


def extend_right(B, T, W, contract_fn: Callable = contract) -> BlockSparseTensor:
    """B' = T_j . W_j . conj(T_j) . B (absorb site j into the right env)."""
    bra = T.conj()
    tmp = contract_fn(T, B, ((2,), (2,)))            # (l, s, i', k')
    tmp = contract_fn(tmp, W, ((3, 1), (3, 2)))      # (l, i', lw, so)
    out = contract_fn(tmp, bra, ((1, 3), (2, 1)))    # (l, lw, l_bra)
    return out.transpose((2, 1, 0))                  # (i', k', l')


def matvec_two_site(A, Wj, Wj1, B, x, contract_fn: Callable = contract) -> BlockSparseTensor:
    """y = K x with K = A . W_j . W_{j+1} . B (paper Fig. 1d), O(m^3 k d)."""
    t = contract_fn(A, x, ((2,), (0,)))              # (i, k, s1, s2, r)
    t = contract_fn(t, Wj, ((1, 2), (0, 2)))         # (i, s2, r, so1, k1)
    t = contract_fn(t, Wj1, ((4, 1), (0, 2)))        # (i, r, so1, so2, k2)
    return contract_fn(t, B, ((4, 1), (1, 2)))       # (i, so1, so2, i')


def expectation(mps_tensors: List[BlockSparseTensor], mpo: List[BlockSparseTensor], contract_fn: Callable = contract) -> float:
    """<psi|H|psi> via a full left-to-right environment sweep."""
    A = left_edge(mps_tensors[0], mpo[0])
    for T, W in zip(mps_tensors, mpo):
        A = extend_left(A, T, W, contract_fn)
    return float(sum(torch.sum(b) for b in A.blocks.values()).real)
