"""Top-level DMRG driver: bond-dimension schedule + sweeps (paper Sec. II-C).

"In doing DMRG, we gradually increase bond dimension of the MPS, sweeping
over all sites multiple times for each successive bond dimension choice."
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..device import resolve_device
from .checkpoint import CheckpointManager, pack_run_state, tensor_restore, unpack_envs
from .mpo import build_mpo, compress_mpo
from .mps import MPS, neel_states, product_state_mps
from .siteops import LocalSpace
from .sweep import DMRGEngine, SweepStats


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
    # with a plan store: what ``persist.warmup`` did before the first sweep
    # (structures replayed, graph captures, seconds); {} without one
    warmup: Dict = dataclasses.field(default_factory=dict)

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
    captures its CUDA graphs again.

    ``plan_store`` (a ``dist.PlanStore`` or a path) activates the persistent
    plan store for this run (``dist/persist.py``): plans are loaded from it
    and written back, and before the first sweep the engine captures every
    padded structure the store records for this environment
    (``persist.warmup``), so a run on a primed store builds no plan and
    captures no graph while it sweeps.  The energies equal a cold run's.

    ``spmd=True`` distributes the run over a ``torch.distributed`` mesh
    (``dist/shard.py``, ``dist/spmd.py``): every bucketed GEMM of the matvec
    and the environment updates is split over the ranks, the pairs over
    "row" and the output columns over "col".  It implies ``jit_matvec=True``
    (padded operands; the matvec itself runs eagerly, since its collectives
    cannot be captured) and needs an engine ``algo``.  Without a
    ``shard_policy`` a policy over the whole world is built, on ``device``'s
    type; in a process with no process group the world is this process
    alone.  A given policy must be in "spmd" mode.  ``shard_policy`` alone
    (``spmd=False``) runs under that policy as it is, e.g. in "storage"
    mode.  The tensors live on the policy's rank device.  Energies equal the
    single-process run to <1e-10 (``tests/test_torch_spmd.py``).
    """
    device = resolve_device(device)
    if spmd:
        if shard_policy is None:
            from ..dist.shard import BlockShardPolicy, make_block_mesh

            shard_policy = BlockShardPolicy(make_block_mesh(device=device), mode="spmd")
        elif shard_policy.mode != "spmd":
            raise ValueError(
                f"spmd=True needs a shard_policy with mode='spmd', got mode={shard_policy.mode!r} "
                f"(storage-mode policies keep the gather-before-compute path; pass spmd=False for that)"
            )
        jit_matvec = True
    if shard_policy is not None:
        device = shard_policy.device
    with contextlib.ExitStack() as stack:
        store = None
        if plan_store is not None:
            from ..dist import persist

            store = stack.enter_context(persist.using_store(plan_store))
        return _run_dmrg_body(
            space, terms, n_sites, bond_schedule, sweeps_per_bond, cutoff, algo, davidson_iters, mpo_cutoff,
            initial_states, dtype, verbose, jit_matvec, pad_matvec, shard_policy, svd_method, jit_env, mpo,
            checkpoint_dir, checkpoint_every, checkpoint_keep, store, device,
        )


def _run_dmrg_body(space, terms, n_sites, bond_schedule, sweeps_per_bond, cutoff, algo, davidson_iters,
                   mpo_cutoff, initial_states, dtype, verbose, jit_matvec, pad_matvec, shard_policy, svd_method,
                   jit_env, mpo, checkpoint_dir, checkpoint_every, checkpoint_keep, store, device) -> DMRGResult:
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
        shard_policy=shard_policy, svd_method=svd_method, jit_env=jit_env, restored_envs=restored_envs,
        device=device,
    )
    if state is not None:
        engine.seed = int(state["seed"])
    warmup = {}
    if store is not None and engine._engine is not None:
        from ..dist import persist

        warmup = persist.warmup(engine._engine, store, device)

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
                      engine_stats=engine.contract_fn.stats() if engine._engine is not None else {},
                      warmup=warmup)
