"""MPO construction from operator terms (AutoMPO-style, paper Sec. V).

Finite-state-machine construction: each MPO bond carries a set of states —
READY (no term started), DONE (term completed, identity onward), and one
partial state per term currently "in flight" — grouped into quantum-number
sectors by the accumulated operator charge.  Long-range terms thread a
connector operator (Id, or the JW parity F for fermionic hops) through
intermediate sites.  ``compress_mpo`` then SVD-truncates every bond (the
paper compresses each order-4 tensor of H "via SVD to a 1e-13 cutoff,
resulting in an MPO with a bond dimension k=26" for the electron system).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tensor.blocksparse import BlockSparseTensor, contract, flip_flow, svd_split
from ..tensor.qn import Charge, IN, Index, OUT, qzero
from .opterm import OpTerm
from .siteops import LocalSpace

READY = ("R",)
DONE = ("D",)


def _state_charge(space: LocalSpace, term: OpTerm, p: int) -> Charge:
    """Charge of partial state (term, p ops placed): Q = -sum dq(first p ops)."""
    nq = len(space.state_charges[0])
    q = list(qzero(nq))
    for name, _ in term.ops[:p]:
        dq = space.op_charge(name)
        for i in range(nq):
            q[i] -= dq[i]
    return tuple(q)


def build_mpo(
    space: LocalSpace,
    terms: Sequence[OpTerm],
    n_sites: int,
    dtype=torch.float64,
    device=None,
) -> List[BlockSparseTensor]:
    """Exact (uncompressed) FSM MPO for the term list, on ``device``
    (``None`` means the CUDA card)."""
    device = resolve_device(device)
    nq = len(space.state_charges[0])
    zero = qzero(nq)

    # ---- bond state sets: bond b sits between sites b and b+1, b in -1..N-1
    bond_states: List[List[tuple]] = []
    for b in range(-1, n_sites):
        states: List[tuple] = []
        if b < n_sites - 1:
            states.append(READY)
        for t_id, t in enumerate(terms):
            first, last = t.sites[0], t.sites[-1]
            if first <= b < last:  # term strictly spans this bond
                p = sum(1 for s in t.sites if s <= b)
                states.append(("P", t_id, p))
        if b >= 0:
            states.append(DONE)
        bond_states.append(states)

    def charge_of(state: tuple) -> Charge:
        if state in (READY, DONE):
            return zero
        _, t_id, p = state
        return _state_charge(space, terms[t_id], p)

    # ---- index construction: group states by charge, remember offsets
    def make_bond_index(states: List[tuple], flow: int):
        by_q: Dict[Charge, List[tuple]] = {}
        for s in states:
            by_q.setdefault(charge_of(s), []).append(s)
        charges = sorted(by_q.keys())
        ix = Index(tuple((q, len(by_q[q])) for q in charges), flow, "mpo")
        loc = {}
        for si, q in enumerate(charges):
            for off, s in enumerate(by_q[q]):
                loc[s] = (si, off)
        return ix, loc

    phys_out = space.index  # flow OUT
    phys_in = space.index.dual()
    # physical sector lookup: state s -> sector position (each state is its own sector)
    phys_sector = {s: s for s in range(space.d)}

    mpo: List[BlockSparseTensor] = []
    for j in range(n_sites):
        # bond b is stored at position b+1; left bond of site j is b=j-1
        lix, lloc = make_bond_index(bond_states[j], IN)
        rix, rloc = make_bond_index(bond_states[j + 1], OUT)

        # transitions: (l_state, r_state) -> d x d matrix
        trans: Dict[Tuple[tuple, tuple], np.ndarray] = {}

        def add(ls, rs, mat):
            if (ls, rs) in trans:
                trans[(ls, rs)] = trans[(ls, rs)] + mat
            else:
                trans[(ls, rs)] = np.array(mat, dtype=np.complex128 if np.iscomplexobj(mat) else np.float64)

        lstates = bond_states[j]
        rstates = set(bond_states[j + 1])
        if READY in lstates and READY in rstates:
            add(READY, READY, space.ops["Id"])
        if DONE in lstates and DONE in rstates:
            add(DONE, DONE, space.ops["Id"])
        for t_id, t in enumerate(terms):
            sites = t.sites
            first, last = sites[0], sites[-1]
            if j < first or j > last:
                continue
            if j == first:
                ls = READY
                op = np.asarray(space.ops[t.ops[0][0]]) * t.coef
                rs = DONE if len(sites) == 1 else ("P", t_id, 1)
                if ls in lstates and rs in rstates:
                    add(ls, rs, op)
                continue
            p = sum(1 for s in sites if s < j)  # ops placed strictly left of j
            ls = ("P", t_id, p)
            if ls not in lstates:
                continue
            if j in sites:
                op = np.asarray(space.ops[t.ops[p][0]])
                rs = DONE if p + 1 == len(sites) else ("P", t_id, p + 1)
            else:
                op = np.asarray(space.ops[t.connector])
                rs = ("P", t_id, p)
            if rs in rstates:
                add(ls, rs, op)

        # ---- fill blocks
        blocks: Dict[tuple, np.ndarray] = {}
        for (ls, rs), mat in trans.items():
            lsec, loff = lloc[ls]
            rsec, roff = rloc[rs]
            for o in range(space.d):
                for i in range(space.d):
                    v = mat[o, i]
                    if abs(v) < 1e-15:
                        continue
                    key = (lsec, phys_sector[o], phys_sector[i], rsec)
                    if key not in blocks:
                        blocks[key] = np.zeros(
                            (lix.sector_dim(lsec), 1, 1, rix.sector_dim(rsec)),
                            dtype=np.float64,
                        )
                    blocks[key][loff, 0, 0, roff] += float(np.real(v))
        w = BlockSparseTensor(
            [lix, phys_out, phys_in, rix],
            {k: torch.as_tensor(b, dtype=dtype, device=device) for k, b in blocks.items()},
        )
        w.check()
        mpo.append(w)
    return mpo


def mpo_bond_dims(mpo: List[BlockSparseTensor]) -> List[int]:
    return [w.indices[3].dim for w in mpo[:-1]]


def compress_mpo(
    mpo: List[BlockSparseTensor], cutoff: float = 1e-13, max_bond: int = 10**9
) -> List[BlockSparseTensor]:
    """SVD-compress every MPO bond (L->R then R->L), preserving l:IN / r:OUT."""
    mpo = list(mpo)
    n = len(mpo)
    for sweep_dir in ("lr", "rl"):
        rng = range(n - 1) if sweep_dir == "lr" else range(n - 2, -1, -1)
        for j in rng:
            theta = contract(mpo[j], mpo[j + 1], axes=((3,), (0,)))
            # modes: (l, o_j, i_j, o_j1, i_j1, r)
            absorb = "right" if sweep_dir == "lr" else "left"
            U, V, _, _ = svd_split(theta, 3, max_bond=max_bond, cutoff=cutoff, absorb=absorb)
            U = flip_flow(U, 3)   # bond IN -> OUT on U's last mode
            V = flip_flow(V, 0)   # bond OUT -> IN on V's first mode
            mpo[j], mpo[j + 1] = U, V
    return mpo
