"""Matrix product states with U(1)^n block sparsity.

Site tensor convention: T_j has indices (l: IN, sigma: OUT, r: OUT) and
tensor charge 0; bond charges accumulate Q_{j+1} = Q_j - q_{sigma_j}, so the
final (dangling, dim-1) right bond carries -Q_total.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..device import resolve_device
from ..tensor.blocksparse import BlockSparseTensor, contract, flip_flow, svd_split
from ..tensor.qn import Charge, IN, Index, OUT, qadd, qzero
from .siteops import LocalSpace


class MPS:
    def __init__(self, tensors: List[BlockSparseTensor]):
        self.tensors = tensors

    @property
    def n_sites(self) -> int:
        return len(self.tensors)

    def bond_dims(self) -> List[int]:
        return [t.indices[2].dim for t in self.tensors[:-1]]

    def max_bond(self) -> int:
        dims = self.bond_dims()
        return max(dims) if dims else 1

    def total_blocks(self) -> int:
        return sum(t.num_blocks for t in self.tensors)

    def norm_sq(self) -> torch.Tensor:
        """<psi|psi> by transfer-matrix contraction, a 0-d tensor on the
        MPS's device (no host sync)."""
        env = None
        for t in self.tensors:
            bra = t.conj()
            if env is None:
                env = contract(bra, t, ((0, 1), (0, 1)))      # (r_bra, r_ket)
            else:
                tmp = contract(env, t, ((1,), (0,)))           # (r_bra, sigma, r)
                env = contract(bra, tmp, ((0, 1), (0, 1)))
        return torch.real(sum(torch.sum(b) for b in env.blocks.values()))

    def copy(self) -> "MPS":
        """A new MPS with new block dicts over the same block tensors."""
        return MPS([BlockSparseTensor(t.indices, dict(t.blocks), t.charge) for t in self.tensors])


def product_state_mps(
    space: LocalSpace, states: Sequence[int], dtype=torch.float64, device=None
) -> MPS:
    """Bond-dimension-1 MPS for a product basis state (e.g. Neel), on
    ``device`` (``None`` means the CUDA card)."""
    device = resolve_device(device)
    nq = len(space.state_charges[0])
    tensors = []
    q_left = qzero(nq)
    for s in states:
        q_right = tuple(a - b for a, b in zip(q_left, space.state_charges[s]))
        lix = Index(((q_left, 1),), IN, "l")
        rix = Index(((q_right, 1),), OUT, "r")
        block = torch.ones((1, 1, 1), dtype=dtype, device=device)
        tensors.append(BlockSparseTensor([lix, space.index, rix], {(0, s, 0): block}))
        q_left = q_right
    return MPS(tensors)


def neel_states(space: LocalSpace, n: int) -> List[int]:
    """Alternating up/down (spins) or up-electron/down-electron (Hubbard
    half filling): a total-charge-zero / half-filled starting state."""
    if space.name == "spin_half":
        return [0 if i % 2 == 0 else 1 for i in range(n)]
    if space.name == "electron":
        return [1 if i % 2 == 0 else 2 for i in range(n)]
    raise ValueError(space.name)


def total_charge(space: LocalSpace, states: Sequence[int]) -> Charge:
    nq = len(space.state_charges[0])
    q = qzero(nq)
    for s in states:
        q = qadd(q, space.state_charges[s])
    return q


def right_canonicalize(mps: MPS, max_bond: int = 10**9, cutoff: float = 0.0) -> MPS:
    """Sweep right to left, SVD-splitting each bond (the per-sector split);
    the orthogonality center lands at site 0."""
    tensors = list(mps.tensors)
    for j in range(len(tensors) - 1, 0, -1):
        theta = contract(tensors[j - 1], tensors[j], ((2,), (0,)))
        U, V, _, _ = svd_split(theta, 2, max_bond=max_bond, cutoff=cutoff, absorb="left")
        tensors[j - 1], tensors[j] = flip_flow(U, 2), flip_flow(V, 0)
    return MPS(tensors)
