"""Observables of an MPS: single-site expectations and two-point
correlation functions (what the paper's physics studies consume, e.g. the
spin-spin correlations of the J1-J2 phase diagram).

Transfer-matrix contractions on the block-sparse substrate, with the bare
``contract`` on the MPS's device; O(N m^3 d) per observable sweep, the
scaling of one environment build.  Each result is one host read.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..tensor.blocksparse import BlockSparseTensor, contract
from ..tensor.qn import IN, Index, OUT, qadd
from .mps import MPS
from .siteops import LocalSpace


def _apply_op(T: BlockSparseTensor, space: LocalSpace, op: np.ndarray) -> BlockSparseTensor:
    """Contract a local operator into the physical leg.  A charged operator
    (S+, c†, ...) shifts the tensor charge, so conservation still holds and
    the environments between the two points carry the charge."""
    blocks = {}
    dq = None
    for key, blk in T.blocks.items():
        s = key[1]
        for so in range(space.d):
            v = op[so, s]
            if abs(v) < 1e-15:
                continue
            nk = (key[0], so, key[2])
            add = float(v) * blk
            blocks[nk] = blocks[nk] + add if nk in blocks else add
            dq = tuple(a - b for a, b in zip(space.state_charges[so], space.state_charges[s]))
    return BlockSparseTensor(T.indices, blocks, T.charge if dq is None else qadd(T.charge, dq))


def _transfer(env: BlockSparseTensor, T: BlockSparseTensor, Top: BlockSparseTensor) -> BlockSparseTensor:
    """env (bra bond, ket bond) -> the next bond, with a possibly modified ket."""
    t = contract(env, Top, ((1,), (0,)))             # (bra, s, r)
    return contract(T.conj(), t, ((0, 1), (0, 1)))   # (r_bra, r_ket)


def _edge(T0: BlockSparseTensor) -> BlockSparseTensor:
    lq = T0.indices[0].sectors
    one = torch.ones((1, 1), dtype=T0.dtype, device=T0.device)
    return BlockSparseTensor([Index(lq, IN, "e_bra"), Index(lq, OUT, "e_ket")], {(0, 0): one})


def _close(env: BlockSparseTensor) -> float:
    return float(torch.real(sum(torch.sum(b) for b in env.blocks.values())))


def _measure(mps: MPS, space: LocalSpace, ops) -> float:
    """<psi| prod_site op_site |psi> / <psi|psi> for ``ops`` {site: name}."""
    env = norm_env = _edge(mps.tensors[0])
    for j, T in enumerate(mps.tensors):
        Top = _apply_op(T, space, np.asarray(space.ops[ops[j]])) if j in ops else T
        env = _transfer(env, T, Top)
        norm_env = _transfer(norm_env, T, T)
    return _close(env) / _close(norm_env)


def site_expectation(mps: MPS, space: LocalSpace, opname: str, site: int) -> float:
    """<psi| op_site |psi> / <psi|psi>."""
    return _measure(mps, space, {site: opname})


def correlation(mps: MPS, space: LocalSpace, op1: str, op2: str, i: int, j: int) -> float:
    """<psi| op1_i op2_j |psi> / <psi|psi> for i < j (the connected part is
    not subtracted)."""
    if not i < j:
        raise ValueError(f"correlation needs i < j, got {i}, {j}")
    return _measure(mps, space, {i: op1, j: op2})


def correlation_profile(mps: MPS, space: LocalSpace, op1: str, op2: str, ref: int = 0) -> List[Tuple[int, float]]:
    """C(r) = <op1_ref op2_(ref+r)> for all r > 0."""
    return [(j - ref, correlation(mps, space, op1, op2, ref, j)) for j in range(ref + 1, mps.n_sites)]
