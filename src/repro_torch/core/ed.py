"""Dense exact-diagonalization oracle for small systems (test reference)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .opterm import OpTerm
from .siteops import LocalSpace


def build_dense_hamiltonian(space: LocalSpace, terms: Sequence[OpTerm], n: int) -> np.ndarray:
    d = space.d
    H = np.zeros((d**n, d**n))
    for t in terms:
        mats = [np.eye(d) for _ in range(n)]
        sites = t.sites
        for (opname, s) in t.ops:
            mats[s] = mats[s] @ np.asarray(space.ops[opname])
        for s in range(sites[0] + 1, sites[-1]):
            if s not in sites:
                mats[s] = mats[s] @ np.asarray(space.ops[t.connector])
        acc = np.ones((1, 1))
        for s in range(n):  # site 0 = most significant kron factor
            acc = np.kron(acc, mats[s])
        H += float(np.real(t.coef)) * acc
    return H


def state_charges_vector(space: LocalSpace, n: int) -> np.ndarray:
    """Total charge of each product basis state, shape [d^n, nq]."""
    d = space.d
    nq = len(space.state_charges[0])
    qs = np.array(space.state_charges)  # [d, nq]
    out = np.zeros((d**n, nq), dtype=np.int64)
    for s in range(n):
        reps = d ** (n - s - 1)
        tiles = d**s
        col = np.repeat(np.tile(np.arange(d), tiles), reps)
        out += qs[col]
    return out


def ground_energy(space: LocalSpace, terms: Sequence[OpTerm], n: int, charge=None) -> float:
    """Smallest eigenvalue of H, optionally restricted to a charge sector."""
    H = build_dense_hamiltonian(space, terms, n)
    if charge is not None:
        mask = np.all(state_charges_vector(space, n) == np.array(charge), axis=1)
        H = H[np.ix_(mask, mask)]
        assert H.shape[0] > 0, f"empty charge sector {charge}"
    return float(np.linalg.eigvalsh(H)[0])
