"""Operator-string terms (the AutoMPO-style front end).

A Hamiltonian is a list of ``OpTerm``: coefficient times a product of named
single-site operators at distinct sites, plus an optional *connector* operator
threaded through every intermediate site (identity for bosonic strings, the
JW parity F for fermionic hopping).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class OpTerm:
    coef: complex
    ops: Tuple[Tuple[str, int], ...]   # ((opname, site), ...) sorted by site
    connector: str = "Id"

    def __post_init__(self):
        sites = [s for _, s in self.ops]
        assert sites == sorted(sites) and len(set(sites)) == len(sites), (
            f"operator sites must be strictly increasing: {sites}"
        )

    @property
    def sites(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.ops)


def term(coef, *ops, connector: str = "Id") -> OpTerm:
    """term(J, ("Sz", i), ("Sz", j)) — sites auto-sorted (bosonic only)."""
    ops = tuple(sorted(ops, key=lambda t: t[1]))
    return OpTerm(coef, ops, connector)


def fermi_hop(coef, adag_op: str, a_op: str, i: int, j: int,
              adagF_op: str, Fa_op: str) -> List[OpTerm]:
    """coef * (c†_i c_j + c†_j c_i) for i != j with JW strings.

    For i<j:  c†_i c_j = (a†F)_i [F...] (a)_j
              c†_j c_i = (Fa)_i  [F...] (a†)_j
    """
    if i > j:
        i, j = j, i
    return [
        OpTerm(coef, ((adagF_op, i), (a_op, j)), connector="F"),
        OpTerm(coef, ((Fa_op, i), (adag_op, j)), connector="F"),
    ]
