"""Multi-problem DMRG core: B parameter-sweep problems through one pipeline.

``davidson_multi`` / ``svd_split_multi`` / ``MultiProblemEngine`` mirror
``core/davidson.py`` / ``dist/decomp.py`` / ``core/sweep.py`` over stacked
tensors (``serve/stacked.py``).  Every device-side stage is the
single-problem code on stacked blocks: the block GEMM of each bucket with
the problem axis folded into its pair axis, batched ``matmul`` pair
products, one SVD per bucket over all problems' sectors.  Every host-side
decision (Davidson convergence, global truncation) is made independently
per problem at the SAME one-sync points the single-problem engines have,
so a batch of B problems costs the host round-trips of one.

Per-problem truncation inside one shared block structure works by masking:
each split keeps ``max_b m_q[b]`` bond states per sector (the batch bond is
the union), and zeroes each problem's U columns, V rows AND singular values
beyond its own retained count.  Both sides must be masked -- a nonzero
orthonormal U column with a zeroed V row would still leak into the
environments.  The retained values within a sector are always a prefix
(singular values descend, ties break by position), so prefix masks are
exact.  Phantom bond slots then carry exact zeros through envs, matvecs and
later splits: each problem evolves as if it ran alone at its own bond
dimension (``tests/test_torch_serve.py`` holds it to its single run,
<1e-10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.davidson import GRAM_NOISE_FLOOR, GS_BREAKDOWN_TOL
from ..core.env import left_edge, right_edge
from ..core.mps import neel_states, product_state_mps
from ..device import resolve_device
from ..dist import faults
from ..dist.decomp import host_truncate, svd_core_body
from ..dist.faults import FaultInjected, NumericalHealthError
from ..tensor.blocksparse import BlockSparseTensor, flip_flow
from ..tensor.qn import IN, Index, OUT, qzero
from .stacked import (
    StackedOps,
    _to_device,
    batch_size,
    binner,
    blincomb,
    bnorm,
    broadcast_tensor,
    bscale,
    bselect,
    pad_stacked,
    stack_tensors,
    unpad_stacked,
)


class StructureMismatch(ValueError):
    """Problems of different MPO block structure in one batch."""


def mpo_structure_signature(mpo: Sequence[BlockSparseTensor]) -> Tuple:
    """Structural signature of an MPO: per site (indices, charge, block keys).

    Two problems batch together iff their MPOs share this signature -- then
    every plan and padded structure of the sweep is identical and the batch
    axis is purely a value axis.
    """
    return tuple((t.indices, t.charge, tuple(sorted(t.blocks))) for t in mpo)


def _host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host read."""
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ Davidson
@dataclasses.dataclass
class MultiDavidsonInfo:
    """Health record of one batched Davidson solve (``DavidsonInfo`` mirror).

    ``converged`` is a per-problem [B] bool array -- as in the single solver,
    False on a budget-limited production solve means "unknown", not
    "diverged".  ``restarts`` counts Gram-Schmidt breakdown events (batch
    restarts are issued for all broken-down problems at once).
    """

    converged: np.ndarray
    iterations: int = 0
    restarts: int = 0


def _new_columns_multi(V, AV, i) -> np.ndarray:
    """M[:, j, i] and W[:, j, i] for j <= i, one device round-trip: [2(i+1), B]."""
    vals = [binner(V[j], AV[i]) for j in range(i + 1)]
    vals += [binner(AV[j], AV[i]) for j in range(i + 1)]
    return np.real(_host(torch.stack(vals)))


def _check_cols_multi(cols: np.ndarray, i: int) -> None:
    """Per-problem health guard on the one existing sync per iteration.

    ``cols`` is [2(i+1), B]; problems stay independent, so a column that is
    non-finite pinpoints exactly the poisoned problems -- the mask lets the
    serving layer fail those requests and retry the rest.
    """
    bad = ~np.isfinite(cols).all(axis=0)
    if bad.any():
        raise NumericalHealthError(
            f"non-finite Rayleigh-Ritz entries at iteration {i} for problems {np.flatnonzero(bad).tolist()}",
            stage="davidson",
            problems=bad,
        )


def davidson_multi(
    matvec: Callable[[BlockSparseTensor], BlockSparseTensor],
    x0: BlockSparseTensor,
    n_iter: int = 2,
    tol: float = 1e-10,
    seed: int = 0,
) -> Tuple[np.ndarray, BlockSparseTensor, MultiDavidsonInfo]:
    """Batched ``core.davidson.davidson``: per-problem eigenpairs, shared syncs.

    The subspace vectors are stacked, so each problem spans its OWN Krylov
    space; only the sync points are shared.  Host-side control flow mirrors
    the reference's batched solver exactly per problem -- the same
    Gram-identity residual with the same noise floor
    (``core.davidson.GRAM_NOISE_FLOOR``), the same exact-norm fallback, the
    same Gram-Schmidt breakdown threshold (``GS_BREAKDOWN_TOL``) and a
    seeded restart -- except that a converged problem keeps riding along
    (its recorded Ritz data frozen, its residual column near zero) until the
    whole batch finishes.  A restart draws its random direction from a
    ``torch.Generator`` seeded with ``seed + i`` on the vector's device, as
    the port's single solver does.  Returns ``(eigenvalues [B], stacked
    eigenvector approximation, health info)``.

    Health guard: the Rayleigh-Ritz column read is checked per problem at
    zero extra sync cost; a NaN-poisoned problem raises
    ``NumericalHealthError`` carrying the [B] mask of exactly the poisoned
    batch positions.
    """
    B = batch_size(x0)
    force_no_converge = faults.fire("davidson.no_converge") is not None
    x = bscale(x0, 1.0 / bnorm(x0))
    V = [x]
    AV = [matvec(x)]
    if n_iter <= 0:
        lam = np.real(_host(binner(V[0], AV[0])))
        bad = ~np.isfinite(lam)
        if bad.any():
            raise NumericalHealthError("non-finite Rayleigh quotient", stage="davidson", problems=bad)
        return lam, x, MultiDavidsonInfo(converged=np.zeros(B, dtype=bool))

    dim = n_iter + 1
    M = np.zeros((B, dim, dim))  # <v_j | A v_i> per problem
    W = np.zeros((B, dim, dim))  # <A v_j | A v_i> per problem
    keep_s = np.zeros((B, dim))
    keep_s[:, 0] = 1.0
    keep_lam = np.zeros(B)
    done = np.zeros(B, dtype=bool)
    info = MultiDavidsonInfo(converged=np.zeros(B, dtype=bool))

    for i in range(n_iter):
        cols = _new_columns_multi(V, AV, i)
        _check_cols_multi(cols, i)
        info.iterations = i + 1
        M[:, : i + 1, i] = M[:, i, : i + 1] = cols[: i + 1].T
        W[:, : i + 1, i] = W[:, i, : i + 1] = cols[i + 1:].T
        evals, evecs = np.linalg.eigh(M[:, : i + 1, : i + 1])
        lam, s = evals[:, 0], evecs[:, :, 0]
        act = ~done
        # freeze this iteration's Ritz data for still-active problems; a
        # problem that converges below keeps exactly the state it broke on
        keep_lam[act] = lam[act]
        keep_s[act, : i + 1] = s[act]
        keep_s[act, i + 1:] = 0.0
        if i == n_iter - 1:
            break

        # residual q = A x - lam x (device-side), norm from the Gram identity
        # above the per-problem cancellation noise floor, measured exactly
        # otherwise (converged regime only) -- one batch sync either way
        q = blincomb(AV[: i + 1], s) - bscale(blincomb(V[: i + 1], s), lam)
        qn2_gram = np.einsum("bi,bij,bj->b", s, W[:, : i + 1, : i + 1], s) - lam * lam
        noise_floor = GRAM_NOISE_FLOOR * np.maximum(1.0, lam * lam)
        qn = np.sqrt(np.where(qn2_gram > 0.0, qn2_gram, 0.0))
        need_exact = act & ~(qn2_gram > noise_floor)
        if need_exact.any():
            qn = np.where(need_exact, _host(bnorm(q)), qn)
        if not force_no_converge:
            done = done | (act & (qn < tol))
        if done.all():
            break

        # modified Gram-Schmidt vs all v_j, per-problem coefficients
        for j in range(i + 1):
            q = q - bscale(V[j], binner(V[j], q))
        qn2 = _host(bnorm(q))
        breakdown = (~done) & (qn2 < GS_BREAKDOWN_TOL * np.maximum(qn, 1.0))
        if breakdown.any():
            info.restarts += 1
            # restart with A·(random), confined to range(A) like the single
            # solver; the same generator seed on the same structure draws
            # the restart vector a padded single run would draw
            gen = torch.Generator(device=x0.device).manual_seed(seed + i)
            r = matvec(broadcast_tensor(
                BlockSparseTensor.random(x0.indices, x0.charge, generator=gen, dtype=x0.dtype), B))
            for j in range(i + 1):
                r = r - bscale(V[j], binner(V[j], r))
            rn2 = _host(bnorm(r))
            q = bselect(breakdown, r, q)
            qn2 = np.where(breakdown, rn2, qn2)
        # converged problems still need a FINITE column (their residual is
        # ~0); leave it unscaled instead of dividing by its vanishing norm
        denom = np.where(done | (qn2 == 0.0), 1.0, qn2)
        q = bscale(q, 1.0 / denom)
        V.append(q)
        AV.append(matvec(q))

    x = blincomb(V, keep_s[:, : len(V)])
    info.converged = done.copy()
    return keep_lam.copy(), bscale(x, 1.0 / bnorm(x)), info


# ----------------------------------------------------------------- SVD split
def _slice_multi(plan, m_q: Tuple[int, ...], bucket_out, masks):
    """``dist.decomp.slice_core_body`` over stacked bucket outputs, each
    sector's U columns, V rows and singular values multiplied by a
    per-problem prefix mask that zeroes the bond slots beyond that problem's
    own retained count (see the module docstring)."""
    u_out, v_out, s_out = [], [], []
    mi = 0
    for si, sec in enumerate(plan.sectors):
        m = m_q[si]
        if m == 0:
            continue
        mask = masks[mi]
        mi += 1
        U, s, Vh = bucket_out[sec.bucket]
        Uq, Vq = U[:, sec.slot], Vh[:, sec.slot]
        B = Uq.shape[0]
        mk = mask.to(Uq.dtype)
        s_out.append(s[:, sec.slot, :m] * mask.to(s.dtype))
        for rk, rd, ro in zip(sec.row_keys, sec.rdims, sec.roffs):
            shp = tuple(ix.sector_dim(sk) for ix, sk in zip(plan.row_ix, rk)) + (m,)
            u_out.append((Uq[:, ro:ro + rd, :m] * mk[:, None, :]).reshape((B,) + shp))
        for ck, cd, co in zip(sec.col_keys, sec.cdims, sec.coffs):
            shp = (m,) + tuple(ix.sector_dim(sk) for ix, sk in zip(plan.col_ix, ck))
            v_out.append((Vq[:, :m, co:co + cd] * mk[:, :, None]).reshape((B,) + shp))
    return u_out, v_out, s_out


def svd_split_multi(
    theta: BlockSparseTensor,
    n_row_modes: int,
    max_bond: int,
    cutoff: float = 1e-12,
    absorb: str = "right",
    ops: Optional[StackedOps] = None,
):
    """Batched planned truncated SVD over a stacked theta.

    One SVD per bucket over all B problems' sectors (``svd_core_body`` on
    the stacked blocks; the plan comes from the engine's decomposition
    cache, shared with single-problem runs; every bucket takes the exact
    SVD, as the reference forces it), ONE host read of all B problems'
    singular values, B independent ``host_truncate`` decisions -- the exact
    single-problem logic -- and one masked slice.  Returns ``(U, V,
    svals_by_sector [B, m], trunc_err [B])``; problem b's retained values
    are the first ``m_q[b]`` entries of each sector, zeros beyond.  The
    split is counted in the decomposition engine's stats like a single
    split (its host syncs are one split's, 2 x buckets + 1 on the card).
    """
    # fault point: forced failure of the stacked SVD core, standing in for
    # a cuSOLVER failure.  No per-problem mask -- the whole call fails -- so
    # the serving layer recovers by slot bisection, not masking.
    if faults.fire("decomp.svd_fail") is not None:
        raise FaultInjected("decomp.svd_fail", "stacked batched SVD did not converge")
    ops = ops if ops is not None else StackedOps()
    decomp = ops.engine.decomp
    t0 = time.perf_counter()
    plan = decomp.cache.get(theta, n_row_modes)
    methods = ("svd",) * plan.num_buckets
    absorb_key = absorb if absorb in ("left", "right") else "none"
    bucket_out, s_cat = svd_core_body(plan, absorb_key, methods, 0)([theta.blocks[k] for k in plan.block_order])
    B = s_cat.shape[0]
    decomp.record_call(plan, methods, 0, s_cat.is_cuda, problems=B)

    # ---- the one host read: all B problems' masked singular values
    s_host = _host(s_cat)  # [B, total]
    # per-problem health guard on the existing sync (problems stay
    # independent, so a non-finite row pinpoints the poisoned ones)
    bad = ~np.isfinite(s_host).all(axis=1)
    if bad.any():
        raise NumericalHealthError(
            f"non-finite singular values for problems {np.flatnonzero(bad).tolist()}", stage="svd", problems=bad)
    k_out = [int(out[1].shape[-1]) for out in bucket_out]
    m_qs = np.zeros((B, plan.num_sectors), np.int64)
    errs = np.zeros(B)
    for b in range(B):
        m_qs[b], errs[b] = host_truncate(plan, s_host[b], k_out, max_bond, cutoff)
    m_tuple = tuple(int(x) for x in m_qs.max(axis=0))
    device = s_cat.device
    masks = [
        _to_device(np.arange(m_tuple[si])[None, :] < m_qs[:, si:si + 1], device)
        for si in range(plan.num_sectors) if m_tuple[si] > 0
    ]
    u_flat, v_flat, s_flat = _slice_multi(plan, m_tuple, bucket_out, masks)

    new_sectors, u_blocks, v_blocks, svals = [], {}, {}, {}
    ui = vi = si_out = 0
    for si, sec in enumerate(plan.sectors):
        m = m_tuple[si]
        if m == 0:
            continue
        svals[sec.q] = s_flat[si_out]
        si_out += 1
        new_sectors.append((sec.q, m))
        for rk in sec.row_keys:
            u_blocks[(sec.q, rk)] = u_flat[ui]
            ui += 1
        for ck in sec.col_keys:
            v_blocks[(sec.q, ck)] = v_flat[vi]
            vi += 1

    bond_u = Index(tuple(new_sectors), IN, "bond")
    bond_v = Index(tuple(new_sectors), OUT, "bond")
    sector_index = {q: i for i, (q, _) in enumerate(new_sectors)}
    U_t = BlockSparseTensor(
        list(plan.row_ix) + [bond_u],
        {rk + (sector_index[q],): blk for (q, rk), blk in u_blocks.items()},
        qzero(theta.indices[0].nq),
    )
    V_t = BlockSparseTensor(
        [bond_v] + list(plan.col_ix),
        {(sector_index[q],) + ck: blk for (q, ck), blk in v_blocks.items()},
        theta.charge,
    )
    decomp.svd_seconds += time.perf_counter() - t0
    return U_t, V_t, svals, errs


# -------------------------------------------------------------------- engine
@dataclasses.dataclass
class MultiSweepStats:
    energies: np.ndarray        # [B] final pair energy per problem
    max_bond: int               # union (batch) bond dimension
    trunc_err: np.ndarray       # [B] max truncation error per problem
    seconds: float              # host clock, ending in a device sync on the card
    davidson_seconds: float = 0.0
    svd_seconds: float = 0.0
    # host clock of the environment updates; on the card mostly enqueue
    # time (their graphs finish inside the next Davidson sync)
    env_seconds: float = 0.0
    # Davidson health ledger (MultiDavidsonInfo, summed over the sweep):
    # solves run, per-problem residual convergences (converged < solves is
    # normal for budget-limited production solves), total inner iterations,
    # and Gram-Schmidt breakdown restart events
    davidson_solves: int = 0
    davidson_converged: Optional[np.ndarray] = None   # [B] counts
    davidson_iterations: int = 0
    davidson_restarts: int = 0


class MultiProblemEngine:
    """Two-site DMRG sweeps over a stacked batch of problems.

    The sweep logic mirrors ``core.sweep.DMRGEngine`` (padded operands,
    per-site padded-MPO cache, absorb-along-the-sweep splits, incremental
    envs) with every stage routed through one shared ``StackedOps`` -- plan
    caches and captured graphs persist across engines and batches, which is
    what makes steady-state serving free of captures.
    """

    def __init__(
        self,
        mps_stacked: List[BlockSparseTensor],
        mpo_stacked: List[BlockSparseTensor],
        ops: Optional[StackedOps] = None,
        davidson_iters: int = 2,
        seed: int = 0,
    ):
        if len(mps_stacked) != len(mpo_stacked):
            raise ValueError(f"MPS has {len(mps_stacked)} sites, MPO {len(mpo_stacked)}")
        self.T = mps_stacked
        self.W = mpo_stacked
        self.ops = ops if ops is not None else StackedOps()
        self.davidson_iters = davidson_iters
        self.seed = seed
        self.n = len(mps_stacked)
        self.B = batch_size(mps_stacked[0])
        self.device = mps_stacked[0].device
        self._mpo_padded: List[Optional[BlockSparseTensor]] = [None] * self.n
        self._init_envs()

    def _padded_mpo(self, j: int) -> BlockSparseTensor:
        if self._mpo_padded[j] is None:
            self._mpo_padded[j] = pad_stacked(self.W[j])
        return self._mpo_padded[j]

    def _env(self, side: str, site: int) -> BlockSparseTensor:
        """The fused update absorbing ``site`` into the environment on
        ``side`` that ends there: left_envs[site] -> left_envs[site + 1],
        right_envs[site] -> right_envs[site - 1]."""
        env = self.left_envs[site] if side == "left" else self.right_envs[site]
        return self.ops.env_update(side, env, self.T[site], self.W[site], mpo_padded=self._padded_mpo(site))

    def _init_envs(self):
        n, T, W = self.n, self.T, self.W
        self.left_envs: List[Optional[BlockSparseTensor]] = [None] * (n + 1)
        self.right_envs: List[Optional[BlockSparseTensor]] = [None] * (n + 1)
        # the edge builders read only indices, dtype and device, so they
        # accept stacked operands; the (1,1,1) ones block is shared
        self.left_envs[0] = broadcast_tensor(left_edge(T[0], W[0]), self.B)
        self.right_envs[n - 1] = broadcast_tensor(right_edge(T[n - 1], W[n - 1]), self.B)
        for j in range(n - 2, 0, -1):
            self.right_envs[j] = self._env("right", j + 1)

    def max_bond(self) -> int:
        dims = [t.indices[2].dim for t in self.T[:-1]]
        return max(dims) if dims else 1

    def _optimize_pair(self, j: int, max_bond: int, cutoff: float, absorb: str):
        T = self.T
        theta = self.ops.contract(T[j], T[j + 1], ((2,), (0,)))
        orig_indices = theta.indices
        A = pad_stacked(self.left_envs[j])
        Bx = pad_stacked(self.right_envs[j + 1])
        theta_p = pad_stacked(theta)
        mv = self.ops.matvec_fn(A, self._padded_mpo(j), self._padded_mpo(j + 1), Bx)
        t_dav = time.perf_counter()
        lam, theta_p, dinfo = davidson_multi(mv, theta_p, n_iter=self.davidson_iters, seed=self.seed + j)
        dav_dt = time.perf_counter() - t_dav
        theta = unpad_stacked(theta_p, orig_indices)
        t_svd = time.perf_counter()
        U, V, _, errs = svd_split_multi(theta, 2, max_bond=max_bond, cutoff=cutoff, absorb=absorb, ops=self.ops)
        svd_dt = time.perf_counter() - t_svd
        T[j] = flip_flow(U, 2)
        T[j + 1] = flip_flow(V, 0)
        return lam, errs, dav_dt, svd_dt, dinfo

    def sweep(self, max_bond: int, cutoff: float = 1e-12) -> MultiSweepStats:
        """One full left-to-right + right-to-left sweep over the batch."""
        n = self.n
        energies = None
        max_err = np.zeros(self.B)
        dav_secs = svd_secs = env_secs = 0.0
        solves = iters = restarts = 0
        converged = np.zeros(self.B, dtype=np.int64)
        t0 = time.perf_counter()

        def site(j: int, absorb: str):
            nonlocal energies, max_err, dav_secs, svd_secs, env_secs, solves, iters, restarts, converged
            lam, errs, dav_dt, svd_dt, dinfo = self._optimize_pair(j, max_bond, cutoff, absorb)
            te = time.perf_counter()
            if absorb == "right":
                self.left_envs[j + 1] = self._env("left", j)
            else:
                self.right_envs[j] = self._env("right", j + 1)
            env_secs += time.perf_counter() - te
            energies = lam
            max_err = np.maximum(max_err, errs)
            dav_secs += dav_dt
            svd_secs += svd_dt
            solves += 1
            iters += dinfo.iterations
            restarts += dinfo.restarts
            converged = converged + dinfo.converged.astype(np.int64)

        for j in range(n - 1):  # left -> right
            site(j, "right")
        for j in range(n - 2, -1, -1):  # right -> left
            site(j, "left")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the sweep's time includes its last kernels
        return MultiSweepStats(
            energies=energies,
            max_bond=self.max_bond(),
            trunc_err=max_err,
            seconds=time.perf_counter() - t0,
            davidson_seconds=dav_secs,
            svd_seconds=svd_secs,
            env_seconds=env_secs,
            davidson_solves=solves,
            davidson_converged=converged,
            davidson_iterations=iters,
            davidson_restarts=restarts,
        )


@dataclasses.dataclass
class MultiDMRGResult:
    energies: np.ndarray                 # [B] final sweep energies
    sweep_stats: List[MultiSweepStats]
    engine: MultiProblemEngine


def run_dmrg_multi(
    space,
    n_sites: int,
    mpos: Sequence[Sequence[BlockSparseTensor]],
    bond_schedule: Sequence[int] = (8, 16, 32),
    sweeps_per_bond: int = 2,
    cutoff: float = 1e-12,
    davidson_iters: int = 3,
    initial_states: Optional[Sequence[int]] = None,
    dtype=torch.float64,
    ops: Optional[StackedOps] = None,
    device=None,
) -> MultiDMRGResult:
    """``core.dmrg.run_dmrg`` over B structure-identical problems at once, on
    ``device`` (``None`` means the CUDA card, raising when there is none).

    ``mpos`` is one pre-built (compressed) MPO per problem, on any device
    (the serving layer builds them on the CPU); all must share one structure
    signature -- the scheduler groups requests so this holds, and it is
    checked here (``StructureMismatch``, a ``ValueError``) because a
    violation would corrupt every problem in the batch.  They are stacked
    and moved to ``device`` here.  Pass a shared ``ops`` to reuse plans and
    captured graphs across calls (the serving path always does).
    """
    device = resolve_device(device)
    sig0 = mpo_structure_signature(mpos[0])
    for mp in mpos[1:]:
        if mpo_structure_signature(mp) != sig0:
            raise StructureMismatch(
                "run_dmrg_multi: MPO structure mismatch across the batch; problems with different block "
                "structures cannot share a stacked pipeline (group by mpo_structure_signature first)"
            )
    W = [stack_tensors([mp[j] for mp in mpos]) for j in range(n_sites)]
    W = [BlockSparseTensor(w.indices, {k: b.to(device=device, dtype=dtype) for k, b in w.blocks.items()}, w.charge)
         for w in W]
    states = list(initial_states) if initial_states is not None else neel_states(space, n_sites)
    mps0 = product_state_mps(space, states, dtype=dtype, device=device)
    T = [broadcast_tensor(t, len(mpos)) for t in mps0.tensors]
    engine = MultiProblemEngine(T, W, ops=ops, davidson_iters=davidson_iters)
    stats: List[MultiSweepStats] = []
    for m in bond_schedule:
        for _ in range(sweeps_per_bond):
            stats.append(engine.sweep(max_bond=m, cutoff=cutoff))
    return MultiDMRGResult(energies=stats[-1].energies, sweep_stats=stats, engine=engine)
