"""The paper's two benchmark Hamiltonians (Sec. V).

*spins*     : 2D J1-J2 Heisenberg model at J2=0.5 on an Lx x Ly cylinder
              (periodic around y, open along x), d=2.
*electrons* : triangular-lattice Hubbard model, t=1, U=8.5, d=4, cylinder.

Site numbering: n = x*Ly + y (column-major along the cylinder axis), matching
the paper's column-of-10-sites sweep timing (their Fig. 6).
"""
from __future__ import annotations

from typing import List, Tuple

from .opterm import OpTerm, fermi_hop, term
from .siteops import LocalSpace, electron_space, spin_half_space


def _site(x: int, y: int, ly: int) -> int:
    return x * ly + (y % ly)


def heisenberg_j1j2_terms(
    lx: int, ly: int, j1: float = 1.0, j2: float = 0.5, cylinder: bool = True
) -> List[OpTerm]:
    """S_i . S_j = 0.5 (S+_i S-_j + S-_i S+_j) + Sz_i Sz_j over J1/J2 bonds."""
    bonds: List[Tuple[int, int, float]] = []

    def add_bond(i: int, j: int, coef: float):
        if i == j:
            return
        a, b = min(i, j), max(i, j)
        bonds.append((a, b, coef))

    for x in range(lx):
        for y in range(ly):
            i = _site(x, y, ly)
            # J1: +x neighbor, +y neighbor (wrap if cylinder)
            if x + 1 < lx:
                add_bond(i, _site(x + 1, y, ly), j1)
            if y + 1 < ly or (cylinder and ly > 2):
                add_bond(i, _site(x, y + 1, ly), j1)
            # J2: diagonal neighbors
            if x + 1 < lx:
                if y + 1 < ly or (cylinder and ly > 2):
                    add_bond(i, _site(x + 1, y + 1, ly), j2)
                if y - 1 >= 0 or (cylinder and ly > 2):
                    add_bond(i, _site(x + 1, y - 1, ly), j2)

    # dedupe (cylinder wrap can double-count on small Ly)
    seen = set()
    terms: List[OpTerm] = []
    for a, b, c in bonds:
        if (a, b, c) in seen:
            continue
        seen.add((a, b, c))
        terms.append(term(0.5 * c, ("S+", a), ("S-", b)))
        terms.append(term(0.5 * c, ("S-", a), ("S+", b)))
        terms.append(term(c, ("Sz", a), ("Sz", b)))
    return terms


def triangular_hubbard_terms(
    lx: int, ly: int, t: float = 1.0, u: float = 8.5, cylinder: bool = True
) -> List[OpTerm]:
    """-t sum_<ij>,sigma (c†_i c_j + h.c.) + U sum_i n_up n_dn on the
    triangular lattice: neighbors +x, +y, and +x-y (cylinder around y)."""
    sp = electron_space()
    bonds: List[Tuple[int, int]] = []

    def add_bond(i: int, j: int):
        if i != j:
            bonds.append((min(i, j), max(i, j)))

    for x in range(lx):
        for y in range(ly):
            i = _site(x, y, ly)
            if x + 1 < lx:
                add_bond(i, _site(x + 1, y, ly))
            if y + 1 < ly or (cylinder and ly > 2):
                add_bond(i, _site(x, y + 1, ly))
            if x + 1 < lx and (y - 1 >= 0 or (cylinder and ly > 2)):
                add_bond(i, _site(x + 1, y - 1, ly))

    terms: List[OpTerm] = []
    seen = set()
    for a, b in bonds:
        if (a, b) in seen:
            continue
        seen.add((a, b))
        for spin in ("up", "dn"):
            terms += fermi_hop(
                -t, f"adag_{spin}", f"a_{spin}", a, b, f"adagF_{spin}", f"Fa_{spin}"
            )
    for n in range(lx * ly):
        terms.append(OpTerm(u, (("nupdn", n),)))
    return terms


def heisenberg_chain_terms(n: int, j: float = 1.0, h: float = 0.0) -> List[OpTerm]:
    """Nearest-neighbor Heisenberg chain J sum_i S_i . S_i+1 + h sum_i Sz_i.

    The (J, h) parameterization is the serving subsystem's sweep axis: every
    (J, h) with h != 0 shares one MPO block structure (and h == 0 another),
    so parameter sweeps batch through a single compiled core.
    """
    terms: List[OpTerm] = []
    for i in range(n - 1):
        terms.append(term(0.5 * j, ("S+", i), ("S-", i + 1)))
        terms.append(term(0.5 * j, ("S-", i), ("S+", i + 1)))
        terms.append(term(j, ("Sz", i), ("Sz", i + 1)))
    if h != 0.0:
        for i in range(n):
            terms.append(term(h, ("Sz", i)))
    return terms


def heisenberg_chain_system(n: int, j: float = 1.0, h: float = 0.0):
    return spin_half_space(), heisenberg_chain_terms(n, j, h)


def spin_system(lx: int, ly: int, j2: float = 0.5):
    return spin_half_space(), heisenberg_j1j2_terms(lx, ly, 1.0, j2)


def electron_system(lx: int, ly: int, t: float = 1.0, u: float = 8.5):
    return electron_space(), triangular_hubbard_terms(lx, ly, t, u)
