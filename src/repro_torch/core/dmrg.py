"""Top-level DMRG driver: bond-dimension schedule + sweeps (paper Sec. II-C).

"In doing DMRG, we gradually increase bond dimension of the MPS, sweeping
over all sites multiple times for each successive bond dimension choice."
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..device import resolve_device
from .mpo import build_mpo, compress_mpo
from .mps import MPS, neel_states, product_state_mps
from .siteops import LocalSpace
from .sweep import DMRGEngine, SweepStats, unported


@dataclasses.dataclass
class DMRGResult:
    energy: float
    mps: MPS
    sweep_stats: List[SweepStats]

    @property
    def energies(self) -> List[float]:
        return [s.energy for s in self.sweep_stats]


def run_dmrg(
    space: LocalSpace,
    terms,
    n_sites: int,
    bond_schedule: Sequence[int] = (8, 16, 32),
    sweeps_per_bond: int = 2,
    cutoff: float = 1e-12,
    algo: str = "list",
    davidson_iters: int = 3,
    mpo_cutoff: float = 1e-13,
    initial_states: Optional[Sequence[int]] = None,
    dtype=torch.float64,
    verbose: bool = False,
    jit_matvec: bool = False,
    pad_matvec: Optional[bool] = None,
    shard_policy=None,
    spmd: bool = False,
    svd_method: Optional[str] = None,
    jit_env: Optional[bool] = None,
    mpo=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 2,
    plan_store=None,
    device=None,
) -> DMRGResult:
    """Ground-state DMRG over a bond-dimension schedule, on ``device``
    (``None`` means the CUDA card, raising when there is none).

    ``algo`` is one of "list", "csr" (the block GEMM kernel on the card),
    "csr_ref" and "list_unplanned"; ``mpo`` optimizes a pre-built operator
    (e.g. one carried across with ``convert.mpo_from_arrays``) instead of
    building and compressing one from ``terms``.  Arguments of the reference
    API that are not ported yet raise ``NotImplementedError``.
    """
    unported(
        jit_matvec=jit_matvec, pad_matvec=pad_matvec, shard_policy=shard_policy,
        spmd=spmd, svd_method=svd_method, jit_env=jit_env,
        checkpoint_dir=checkpoint_dir, plan_store=plan_store,
    )
    device = resolve_device(device)
    if mpo is None:
        mpo = build_mpo(space, terms, n_sites, dtype=dtype, device=device)
        if mpo_cutoff is not None:
            mpo = compress_mpo(mpo, cutoff=mpo_cutoff)
    states = list(initial_states) if initial_states is not None else neel_states(space, n_sites)
    mps = product_state_mps(space, states, dtype=dtype, device=device)
    engine = DMRGEngine(mps, mpo, algo=algo, davidson_iters=davidson_iters, device=device)

    stats: List[SweepStats] = []
    for m in bond_schedule:
        for _ in range(sweeps_per_bond):
            s = engine.sweep(max_bond=m, cutoff=cutoff)
            stats.append(s)
            if verbose:
                print(
                    f"m={m:6d} E={s.energy:+.10f} maxbond={s.max_bond} "
                    f"trunc={s.trunc_err:.2e} t={s.seconds:.2f}s"
                )
    return DMRGResult(energy=stats[-1].energy, mps=engine.mps, sweep_stats=stats)
