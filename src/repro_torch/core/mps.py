"""Matrix product states with U(1)^n block sparsity.

Site tensor convention: T_j has indices (l: IN, sigma: OUT, r: OUT) and
tensor charge 0; bond charges accumulate Q_{j+1} = Q_j - q_{sigma_j}, so the
final (dangling, dim-1) right bond carries -Q_total.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..device import resolve_device
from ..tensor.blocksparse import BlockSparseTensor
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
