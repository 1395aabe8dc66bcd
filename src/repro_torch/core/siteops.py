"""Local Hilbert spaces and operators for the paper's two benchmark systems.

*spins*     : d=2 spin-1/2, one U(1) charge (2*Sz)                (Sec. V, J1-J2)
*electrons* : d=4 Hubbard site, two U(1) charges (N, 2*Sz)        (Sec. V)

Operators are plain numpy matrices in the sector-ordered basis; the physical
``Index`` orders sectors exactly as the basis states, so <out|op|in> maps to
block-sparse entries directly.  Fermionic signs use the Jordan-Wigner parity
operator F; within-site species order is c†_up before c†_dn.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..tensor.qn import Charge, IN, Index, OUT


@dataclasses.dataclass
class LocalSpace:
    name: str
    index: Index                    # physical index, flow OUT, one state per basis vector
    ops: Dict[str, np.ndarray]      # dense d x d matrices <out|op|in>
    state_charges: Tuple[Charge, ...]  # charge of each basis state

    @property
    def d(self) -> int:
        return self.index.dim

    def op_charge(self, name: str) -> Charge:
        """Charge transferred by the operator (must be homogeneous)."""
        op = self.ops[name]
        dq = None
        for o in range(self.d):
            for i in range(self.d):
                if abs(op[o, i]) > 1e-14:
                    q = tuple(a - b for a, b in zip(self.state_charges[o], self.state_charges[i]))
                    assert dq is None or dq == q, f"{name} is not charge-homogeneous"
                    dq = q
        return dq if dq is not None else (0,) * len(self.state_charges[0])


def spin_half_space() -> LocalSpace:
    """Basis |up>, |down>; charge = 2*Sz in {+1, -1}."""
    sz = np.diag([0.5, -0.5])
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])  # S+ |down> = |up>
    sm = sp.T
    eye = np.eye(2)
    index = Index((((1,), 1), ((-1,), 1)), OUT, "spin")
    return LocalSpace(
        "spin_half",
        index,
        {"Id": eye, "Sz": sz, "S+": sp, "S-": sm},
        (((1,)), ((-1,))),
    )


def electron_space() -> LocalSpace:
    """Basis |0>, |up>, |dn>, |updn>; charges (N, 2*Sz).

    |updn> := c†_up c†_dn |0>.  Local annihilators (JW-resolved within site):
      a_up |up> = |0>,   a_up |updn> =  |dn>
      a_dn |dn> = |0>,   a_dn |updn> = -|up>
    F = (-1)^n = diag(1, -1, -1, 1).
    """
    d = 4
    a_up = np.zeros((d, d))
    a_up[0, 1] = 1.0
    a_up[2, 3] = 1.0
    a_dn = np.zeros((d, d))
    a_dn[0, 2] = 1.0
    a_dn[1, 3] = -1.0
    adag_up = a_up.T
    adag_dn = a_dn.T
    F = np.diag([1.0, -1.0, -1.0, 1.0])
    n_up = adag_up @ a_up
    n_dn = adag_dn @ a_dn
    eye = np.eye(d)
    state_charges = ((0, 0), (1, 1), (1, -1), (2, 0))
    index = Index(
        (((0, 0), 1), ((1, 1), 1), ((1, -1), 1), ((2, 0), 1)), OUT, "electron"
    )
    ops = {
        "Id": eye,
        "F": F,
        "a_up": a_up,
        "a_dn": a_dn,
        "adag_up": adag_up,
        "adag_dn": adag_dn,
        "n_up": n_up,
        "n_dn": n_dn,
        "ntot": n_up + n_dn,
        "nupdn": n_up @ n_dn,
        # JW-dressed hopping endpoints: c†_i c_j (i<j) = (a†_i F_i) [F] (a_j),
        # c†_j c_i (i<j) = (F_i a_i) [F] (a†_j);  see core/mpo.py
        "adagF_up": adag_up @ F,
        "adagF_dn": adag_dn @ F,
        "Fa_up": F @ a_up,
        "Fa_dn": F @ a_dn,
    }
    return LocalSpace("electron", index, ops, state_charges)
