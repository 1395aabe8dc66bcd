"""Top-level DMRG driver: bond-dimension schedule + sweeps (paper Sec. II-C).

"In doing DMRG, we gradually increase bond dimension of the MPS, sweeping
over all sites multiple times for each successive bond dimension choice."
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..device import resolve_device
from .checkpoint import CheckpointManager, pack_run_state, tensor_restore, unpack_envs
from .mpo import build_mpo, compress_mpo
from .mps import MPS, neel_states, product_state_mps
from .siteops import LocalSpace
from .sweep import DMRGEngine, SweepStats, unported


@dataclasses.dataclass
class DMRGResult:
    energy: float
    mps: MPS
    sweep_stats: List[SweepStats]
    # host time of this process's checkpoint writes (pickle, fsync, rename),
    # in seconds; 0 without ``checkpoint_dir``
    checkpoint_seconds: float = 0.0
    # the contraction engine's ``stats()`` at the run's end (this process's
    # part of it after a resume): the ladders' retries and degradations, the
    # backend dispatch, the SVD and environment stages; {} for a bare
    # contractor
    engine_stats: Dict = dataclasses.field(default_factory=dict)

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

    ``algo`` is any name of ``core.env.get_contractor``: "list", "dense",
    "csr" (one block GEMM kernel launch per contraction on the card),
    "batched" (one per shape bucket), "auto" / "planned" (the cost model's
    choice per contraction), "csr_ref" and the seed ``*_unplanned``
    algorithms; ``jit_matvec``, ``pad_matvec``, ``svd_method`` and
    ``jit_env`` are as in ``DMRGEngine`` (the reference's defaults: the
    planned SVD and fused environment updates on an engine).  The
    reference's fast configuration is ``algo="auto", jit_matvec=True``.
    ``mpo`` optimizes a pre-built operator (e.g. one carried across with
    ``convert.mpo_from_arrays``) instead of building and compressing one
    from ``terms``.

    With ``checkpoint_dir`` set, the whole sweep state (MPS, both
    environment lists, schedule position, partial in-sweep accumulators,
    Davidson seed) is written atomically every ``checkpoint_every`` site
    updates and at every sweep boundary, keeping the newest
    ``checkpoint_keep`` files; a rerun with the same arguments resumes from
    the newest checkpoint, mid-sweep if that is where it died, with the
    uninterrupted run's energies (``core/checkpoint.py``).  A resumed run
    captures its CUDA graphs again.  ``plan_store``, ``shard_policy`` and
    ``spmd`` are not ported yet and raise ``NotImplementedError``.
    """
    unported(shard_policy=shard_policy, spmd=spmd, plan_store=plan_store)
    device = resolve_device(device)
    if mpo is None:
        mpo = build_mpo(space, terms, n_sites, dtype=dtype, device=device)
        if mpo_cutoff is not None:
            mpo = compress_mpo(mpo, cutoff=mpo_cutoff)
    states = list(initial_states) if initial_states is not None else neel_states(space, n_sites)
    mps = product_state_mps(space, states, dtype=dtype, device=device)

    ckpt = CheckpointManager(checkpoint_dir, every=checkpoint_every, keep=checkpoint_keep) if checkpoint_dir else None
    state = ckpt.load_latest() if ckpt is not None else None
    restored_envs = None
    stats: List[SweepStats] = []
    step = start_bi = start_si = 0
    sweep_resume = None
    if state is not None:
        mps.tensors = [tensor_restore(t, device) for t in state["mps"]]
        restored_envs = unpack_envs(state, device)
        stats = [SweepStats(**d) for d in state["stats"]]
        step = int(state["step"])
        start_bi, start_si = int(state["bond_idx"]), int(state["sweep_idx"])
        sweep_resume = state["sweep_resume"]
    engine = DMRGEngine(
        mps, mpo, algo=algo, davidson_iters=davidson_iters, jit_matvec=jit_matvec, pad_matvec=pad_matvec,
        svd_method=svd_method, jit_env=jit_env, restored_envs=restored_envs, device=device,
    )
    if state is not None:
        engine.seed = int(state["seed"])

    def snapshot(bi: int, si: int, resume_state):
        return pack_run_state(step=step, bond_idx=bi, sweep_idx=si, sweep_resume=resume_state,
                              mps_tensors=engine.mps.tensors, left_envs=engine.left_envs,
                              right_envs=engine.right_envs, stats=stats, seed=engine.seed)

    for bi, m in enumerate(bond_schedule):
        for si in range(sweeps_per_bond):
            if (bi, si) < (start_bi, start_si):
                continue
            resume = sweep_resume if (bi, si) == (start_bi, start_si) else None
            on_site = None
            if ckpt is not None:

                def on_site(rs, _bi=bi, _si=si):
                    nonlocal step
                    step += 1
                    if rs is not None:  # the sweep's end is saved below instead
                        ckpt.maybe_save(snapshot(_bi, _si, rs))

            s = engine.sweep(max_bond=m, cutoff=cutoff, resume=resume, on_site=on_site)
            stats.append(s)
            if ckpt is not None:
                # the boundary checkpoint points at the NEXT schedule slot, so
                # a crash between sweeps resumes at the next sweep
                ckpt.save(snapshot(*((bi, si + 1) if si + 1 < sweeps_per_bond else (bi + 1, 0)), None))
            if verbose:
                print(
                    f"m={m:6d} E={s.energy:+.10f} maxbond={s.max_bond} "
                    f"trunc={s.trunc_err:.2e} t={s.seconds:.2f}s"
                )
    return DMRGResult(energy=stats[-1].energy, mps=engine.mps, sweep_stats=stats,
                      checkpoint_seconds=ckpt.save_seconds if ckpt is not None else 0.0,
                      engine_stats=engine.contract_fn.stats() if engine._engine is not None else {})
