"""U(1)^n quantum-number (charge) machinery.

The paper (Levy/Solomonik/Clark 2020, Sec. II-D) restricts to abelian U(1)
symmetries: total S_z for the spin system and (particle number, 2*S_z) for the
electron system.  A charge is a tuple of integers; composition is element-wise
addition.  Every tensor index carries a list of (charge, degeneracy) sectors
and a *flow* (+1 outgoing / -1 incoming); a block is nonzero only when

    sum_i flow_i * charge_i == tensor.charge      (element-wise).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

Charge = Tuple[int, ...]

OUT = +1  # flow: charge leaves the tensor along this index
IN = -1   # flow: charge enters the tensor along this index


def qadd(a: Charge, b: Charge) -> Charge:
    return tuple(x + y for x, y in zip(a, b))


def qneg(a: Charge) -> Charge:
    return tuple(-x for x in a)


def qscale(a: Charge, s: int) -> Charge:
    return tuple(s * x for x in a)


def qzero(nq: int) -> Charge:
    return (0,) * nq


@dataclasses.dataclass(frozen=True)
class Index:
    """A tensor mode: ordered charge sectors with degeneracies and a flow.

    ``sectors`` is a tuple of (charge, dim) with distinct charges; the dense
    dimension of the mode is ``sum(dim)``.  Two indices can be contracted iff
    they have identical sectors and opposite flows.
    """

    sectors: Tuple[Tuple[Charge, int], ...]
    flow: int = OUT
    name: str = dataclasses.field(default="", compare=False)

    def __post_init__(self):
        assert self.flow in (OUT, IN)
        charges = [q for q, _ in self.sectors]
        assert len(set(charges)) == len(charges), f"duplicate charges: {charges}"
        assert all(d > 0 for _, d in self.sectors)

    # -- basic queries ------------------------------------------------------
    @property
    def nq(self) -> int:
        return len(self.sectors[0][0])

    @property
    def dim(self) -> int:
        return sum(d for _, d in self.sectors)

    @property
    def num_sectors(self) -> int:
        return len(self.sectors)

    def charge(self, s: int) -> Charge:
        return self.sectors[s][0]

    def sector_dim(self, s: int) -> int:
        return self.sectors[s][1]

    def sector_of(self, q: Charge) -> int:
        for i, (qi, _) in enumerate(self.sectors):
            if qi == q:
                return i
        raise KeyError(q)

    def offsets(self) -> Tuple[int, ...]:
        """Dense offset of each sector when blocks are embedded densely."""
        out, acc = [], 0
        for _, d in self.sectors:
            out.append(acc)
            acc += d
        return tuple(out)

    # -- algebra ------------------------------------------------------------
    def dual(self) -> "Index":
        """Same sectors, opposite flow (for contraction partners)."""
        return Index(self.sectors, -self.flow, self.name + "*")

    def with_flow(self, flow: int) -> "Index":
        return Index(self.sectors, flow, self.name)

    def can_contract(self, other: "Index") -> bool:
        return self.sectors == other.sectors and self.flow == -other.flow


def fuse_sectors(
    indices: Sequence[Index], signs: Sequence[int] | None = None
) -> dict:
    """Map fused charge -> list of (sector-position tuple, dims tuple).

    ``signs[i]`` multiplies the flow of index i (used to orient row vs column
    groups when matricizing).  The fused charge of a sector combination is
    sum_i signs[i]*flow_i*charge_i.
    """
    if signs is None:
        signs = [1] * len(indices)
    nq = indices[0].nq
    table: dict = {}

    def rec(i: int, q: Charge, pos: tuple, dims: tuple):
        if i == len(indices):
            table.setdefault(q, []).append((pos, dims))
            return
        idx = indices[i]
        for s, (qs, d) in enumerate(idx.sectors):
            rec(i + 1, qadd(q, qscale(qs, signs[i] * idx.flow)), pos + (s,), dims + (d,))

    rec(0, qzero(nq), (), ())
    return table


def make_index(sector_dims: Iterable[Tuple[Charge, int]], flow: int = OUT, name: str = "") -> Index:
    return Index(tuple(sector_dims), flow, name)
