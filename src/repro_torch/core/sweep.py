"""Two-site DMRG sweeps (paper Sec. II-C, Fig. 1c-e).

Maintains left/right environments incrementally, optimizes each neighboring
pair with Davidson on the two-site matvec, splits the result with the
blockwise truncated SVD (absorbing the singular values along the sweep
direction), and extends the environment by one site.  Every contraction
goes through the contractor of ``algo`` (``core/env.get_contractor``).

With an engine (every ``algo`` but "list_unplanned") the pipeline follows
the reference's engine path:
- ``jit_matvec``: the Davidson matvec replays one CUDA graph per padded
  structure (``ContractionEngine.matvec_fn(jit=True)``), on operands padded
  to powers of two (``pad_matvec``, on when ``jit_matvec`` is);
- ``svd_method``: ``None`` (or "svd") is the planned batched SVD
  (``dist/decomp.py``), "randomized" and "auto" its randomized variants,
  "unplanned" the per-sector loop ``tensor.blocksparse.svd_split``;
- ``jit_env`` (on by default): each environment update, and the
  right-to-left rebuild at startup, is one fused update replayed as a CUDA
  graph per padded structure (``dist/envcore.py``); off, the three-call
  ``extend_left`` / ``extend_right``.
A bare contractor takes the per-sector SVD and the three-call updates, and
refuses the options it cannot honour.

Failures recover on documented ladders, every rung on the run's device, and
every recovery is counted (``ContractionEngine.stats()["retries"]`` and
``["degradations"]``, ``SweepStats.pair_retries``), so a clean run reads
zero everywhere.  A ladder recovers only from ``faults.RECOVERABLE`` (an
injected fault, a health guard's finding); a kernel that does not build or
launch, or a failed capture, propagates:
- a fused environment update that raises a recoverable error is redone by
  the three-call ``extend_left`` / ``extend_right`` ("env_seed");
- a pair whose optimization meets a ``NumericalHealthError`` or an injected
  fault is redone from its untouched inputs on the seed code paths: the
  bare ``contract``, Davidson on it, the per-sector SVD ("pair_seed");
- contractions and splits have their own ladders (``dist/engine.py``,
  ``dist/decomp.py``).
An error on the last rung propagates.

``sweep(resume=, on_site=)`` and ``restored_envs`` carry a run across a
crash (``core/checkpoint.py``).

A ``shard_policy`` (``dist/shard.py``) distributes the run over a
``torch.distributed`` mesh.  Every rank runs this whole sweep.  In "spmd"
mode the MPS and MPO are moved to the rank's device once, here, and the
engine splits every bucketed GEMM of the matvec and the environment
updates over the ranks (``dist/spmd.py``); in "storage" mode the stored
tensors are sharded and gathered before each use.  Either way every host
decision (Davidson's, the truncation's) is taken on rank 0's values
(``BlockShardPolicy.host_values``), so the ranks issue the same
collectives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import kernels
from ..device import resolve_device
from ..dist.batch import pad_block_sparse, unpad_block_sparse
from ..dist import faults
from ..dist import plan as plan_mod
from ..dist.engine import ContractionEngine
from ..dist.faults import RECOVERABLE, FaultInjected
from ..tensor.blocksparse import BlockSparseTensor, contract, flip_flow, svd_split
from .davidson import davidson
from .env import extend_left, extend_right, get_contractor, left_edge, matvec_two_site, right_edge
from .mps import MPS

SVD_METHODS = (None, "unplanned", "svd", "randomized", "auto")


@dataclasses.dataclass
class SweepStats:
    energy: float
    max_bond: int
    trunc_err: float
    seconds: float
    site_seconds: List[float]
    site_energies: List[float]
    # host wall-clock of the decomposition stage this sweep, in seconds; it
    # includes the singular-value sync, so it covers the SVD work itself
    svd_seconds: float = 0.0
    # host wall-clock of the environment updates this sweep, in seconds; on
    # the card this is mostly enqueue time (kernels run asynchronously and
    # finish inside the next Davidson sync)
    env_seconds: float = 0.0
    # Davidson health ledger (core/davidson.py DavidsonInfo) for the sweep
    davidson_solves: int = 0
    davidson_converged: int = 0
    davidson_iterations: int = 0
    davidson_restarts: int = 0
    davidson_exhausted: int = 0
    # contraction work this sweep: the exact block-pair flops of every
    # contraction, and the padded flops the csr backend's packed batches span
    # (a graph replay runs contractions without the engine: with jit_matvec
    # these count the captured structures, not the replays)
    flops_list: float = 0.0
    flops_csr: float = 0.0
    # contractions this sweep per backend (under "auto", the cost model's
    # choices); with jit_matvec these too count captures, not replays
    backend_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # shape buckets those batched contractions ran, one block GEMM launch
    # each (captures and eager calls, as backend_counts)
    buckets: int = 0
    # block GEMM work lists the host planner built this sweep, and their
    # milliseconds (dist/plan.py WORK_LISTS)
    work_lists: int = 0
    work_list_ms: float = 0.0
    # the engine's graph cache (dist/graphs.py): its counters' growth this
    # sweep (graph_captures, graph_replays, evictions, buffer_growths,
    # capture_seconds, instantiate_seconds) and its pool_bytes and
    # buffer_bytes at the sweep's end
    graphs: Dict[str, float] = dataclasses.field(default_factory=dict)
    # block GEMM launches on the card this sweep, by variant, replays included
    block_gemm_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the card's peak allocated bytes at the sweep's end, since the peak was
    # last reset (torch.cuda.reset_peak_memory_stats); 0 on the CPU
    peak_bytes: int = 0
    # pair optimizations that failed the fast path (NumericalHealthError or
    # an injected fault) and were redone on the seed rung; 0 on a healthy run
    pair_retries: int = 0


class DMRGEngine:
    """Alternating two-site optimization with incremental environments.

    ``device=None`` means the CUDA card (raising when there is none); the
    MPS and MPO must already lie on the resolved device.  ``shard_policy``
    (a ``BlockShardPolicy``, engine backends only) distributes the run; see
    the module docstring.
    """

    def __init__(
        self,
        mps: MPS,
        mpo: List[BlockSparseTensor],
        algo: str = "list",
        davidson_iters: int = 2,
        seed: int = 0,
        jit_matvec: bool = False,
        pad_matvec: Optional[bool] = None,
        shard_policy=None,
        engine=None,
        svd_method: Optional[str] = None,
        jit_env: Optional[bool] = None,
        restored_envs=None,
        device=None,
    ):
        if mps.n_sites != len(mpo):
            raise ValueError(f"MPS has {mps.n_sites} sites, MPO {len(mpo)}")
        if svd_method not in SVD_METHODS:
            raise ValueError(f"unknown svd_method: {svd_method!r}")
        self.device = resolve_device(device)
        for t in list(mps.tensors) + list(mpo):
            if t.device is not None and t.device.type != self.device.type:
                raise ValueError(f"tensor on {t.device}, engine on {self.device}")
        self.mps = mps
        self.mpo = mpo
        self.algo = algo
        self.contract_fn = engine if engine is not None else get_contractor(algo, self.device)
        self.jit_matvec = jit_matvec
        # power-of-two pad the Davidson operands so the graphed matvec meets
        # few structures; on iff jitting unless asked
        self.pad_matvec = jit_matvec if pad_matvec is None else pad_matvec
        # the MPO is fixed for the run: each site is padded once
        self._mpo_padded: List[Optional[BlockSparseTensor]] = [None] * len(mpo)
        if isinstance(self.contract_fn, ContractionEngine):
            self.svd_planned = svd_method != "unplanned"
            self.contract_fn.decomp.method = svd_method if svd_method in ("svd", "randomized", "auto") else "svd"
            self.jit_env = True if jit_env is None else bool(jit_env)
        else:
            backend = f"algo={algo!r}" if engine is None else f"engine={type(engine).__name__}"
            for name, bad in (("jit_matvec", jit_matvec), ("svd_method", svd_method not in (None, "unplanned")),
                              ("jit_env", jit_env)):
                if bad:
                    raise ValueError(
                        f"{name} requires a ContractionEngine backend, not {backend}; bare "
                        f"contractors use the per-sector svd_split and extend_left/extend_right"
                    )
            if shard_policy is not None:
                raise ValueError(f"shard_policy requires a ContractionEngine backend, not {backend}")
            self.svd_planned = False
            self.jit_env = False
        self.shard_policy = shard_policy
        self._host = shard_policy.host_values if shard_policy is not None else None
        if self._engine is not None:
            # the policy is set (or reset) on the engine, as the reference does
            self.contract_fn.policy = shard_policy
            self.contract_fn.decomp.host = self._host
        if shard_policy is not None:
            self.mps.tensors = shard_policy.place_mps(self.mps.tensors)
            self.mpo = shard_policy.place_mps(self.mpo)
        self.davidson_iters = davidson_iters
        self.seed = seed
        self.n = mps.n_sites
        if restored_envs is not None:
            # a checkpoint's exact copies of both lists: mid-sweep the right
            # environments are partly stale, a state a rebuild cannot
            # reproduce, so restoring them keeps a resume bit-identical
            self.left_envs, self.right_envs = (list(e) for e in restored_envs)
            if len(self.left_envs) != self.n + 1 or len(self.right_envs) != self.n + 1:
                raise ValueError(f"restored environments for {len(self.left_envs) - 1} sites, MPS has {self.n}")
        else:
            self._init_envs()

    @property
    def _engine(self) -> Optional[ContractionEngine]:
        return self.contract_fn if isinstance(self.contract_fn, ContractionEngine) else None

    def _init_envs(self):
        """Edges, then the right environments down to site 1 (the first pair
        needs ``right_envs[1]``): one right-to-left pass, fused updates when
        ``jit_env`` is on."""
        n = self.n
        T, W = self.mps.tensors, self.mpo
        self.left_envs: List[Optional[BlockSparseTensor]] = [None] * (n + 1)
        self.right_envs: List[Optional[BlockSparseTensor]] = [None] * (n + 1)
        self.left_envs[0] = self._place(left_edge(T[0], W[0]))
        self.right_envs[n - 1] = self._place(right_edge(T[n - 1], W[n - 1]))
        for j in range(n - 2, 0, -1):
            self.right_envs[j] = self._place(self._extend_right_env(j))

    def _extend_left_env(self, j: int) -> BlockSparseTensor:
        """A_{j+1} from A_j: absorb site j into the left environment."""
        A, T, W = self.left_envs[j], self.mps.tensors[j], self.mpo[j]
        if self.jit_env:
            try:
                return self.contract_fn.env_update_left(A, T, W, mpo_padded=self._padded_mpo(j))
            except RECOVERABLE:
                self._note_env_fallback()
        return extend_left(A, T, W, self.contract_fn)

    def _extend_right_env(self, j: int) -> BlockSparseTensor:
        """B_j from B_{j+1}: absorb site j+1 into the right environment."""
        B, T, W = self.right_envs[j + 1], self.mps.tensors[j + 1], self.mpo[j + 1]
        if self.jit_env:
            try:
                return self.contract_fn.env_update_right(B, T, W, mpo_padded=self._padded_mpo(j + 1))
            except RECOVERABLE:
                self._note_env_fallback()
        return extend_right(B, T, W, self.contract_fn)

    def _note_env_fallback(self) -> None:
        """The fused update raised a recoverable error: the caller redoes it
        on the three-call path, equal to it block for block.  Any other error
        (a failed capture, a launch error) propagates."""
        self.contract_fn.note_retry("env")
        self.contract_fn.note_degradation("env_seed")

    def _padded_mpo(self, j: int) -> BlockSparseTensor:
        if self._mpo_padded[j] is None:
            self._mpo_padded[j] = pad_block_sparse(self._whole(self.mpo[j]))
        return self._mpo_padded[j]

    def _place(self, t: BlockSparseTensor) -> BlockSparseTensor:
        """A stored tensor (site or environment) placed per the policy."""
        return t if self.shard_policy is None else self.shard_policy.place(t)

    def _whole(self, t: BlockSparseTensor) -> BlockSparseTensor:
        """A stored tensor whole on this rank (gathered in storage mode)."""
        return t if self.shard_policy is None else self.shard_policy.replicated(t)

    def _optimize_pair(self, j: int, max_bond: int, cutoff: float, absorb: str):
        """Optimize pair (j, j+1), redoing it on the seed rung on failure.

        A ``NumericalHealthError`` (a guard at a host sync saw non-finite
        values, e.g. a NaN-poisoned GEMM at the Davidson Rayleigh-Ritz
        read) or an injected fault aborts the fast path before any MPS
        tensor is written, so the seed rung starts from the same inputs.
        """
        try:
            return self._optimize_pair_fast(j, max_bond, cutoff, absorb)
        except RECOVERABLE:
            if self._engine is not None:
                self._engine.note_retry("pair")
                self._engine.note_degradation("pair_seed")
            return self._optimize_pair_seed(j, max_bond, cutoff, absorb)

    def _optimize_pair_seed(self, j: int, max_bond: int, cutoff: float, absorb: str):
        """The bottom rung: the pair on the seed code paths (the bare
        ``contract``, Davidson on it, the per-sector SVD), on the run's
        device, with no engine involved."""
        T, W = self.mps.tensors, self.mpo
        A, B, Wj, Wj1, Tj, Tj1 = (self._whole(t) for t in (self.left_envs[j], self.right_envs[j + 1], W[j],
                                                            W[j + 1], T[j], T[j + 1]))
        theta = contract(Tj, Tj1, ((2,), (0,)))
        lam, theta, dinfo = davidson(lambda x: matvec_two_site(A, Wj, Wj1, B, x, contract), theta,
                                     n_iter=self.davidson_iters, seed=self.seed + j, host=self._host)
        t_svd = time.perf_counter()
        U, V, _, err = svd_split(theta, 2, max_bond=max_bond, cutoff=cutoff, absorb=absorb, host=self._host)
        svd_dt = time.perf_counter() - t_svd
        T[j] = self._place(flip_flow(U, 2))
        T[j + 1] = self._place(flip_flow(V, 0))
        return lam, err, svd_dt, dinfo

    def _optimize_pair_fast(self, j: int, max_bond: int, cutoff: float, absorb: str):
        T, W = self.mps.tensors, self.mpo
        A, B = self._whole(self.left_envs[j]), self._whole(self.right_envs[j + 1])
        theta = self.contract_fn(T[j], T[j + 1], ((2,), (0,)))
        engine = self._engine
        pad = self.pad_matvec and engine is not None
        if pad:
            # zero padding is exact (the padded operator entries are zero)
            # and quantizes the structure the graphed matvec is keyed by
            orig_indices = theta.indices
            A, B, theta = pad_block_sparse(A), pad_block_sparse(B), pad_block_sparse(theta)
            Wj, Wj1 = self._padded_mpo(j), self._padded_mpo(j + 1)
        else:
            Wj, Wj1 = self._whole(W[j]), self._whole(W[j + 1])
        if engine is not None:
            mv = engine.matvec_fn(A, Wj, Wj1, B, jit=self.jit_matvec)
        else:
            def mv(x):
                return matvec_two_site(A, Wj, Wj1, B, x, self.contract_fn)

        lam, theta, dinfo = davidson(mv, theta, n_iter=self.davidson_iters, seed=self.seed + j, host=self._host)
        if pad:
            theta = unpad_block_sparse(theta, orig_indices)
        t_svd = time.perf_counter()
        if self.svd_planned:
            U, V, _, err = engine.svd_split(theta, 2, max_bond=max_bond, cutoff=cutoff, absorb=absorb)
        else:
            U, V, _, err = svd_split(theta, 2, max_bond=max_bond, cutoff=cutoff, absorb=absorb, host=self._host)
        svd_dt = time.perf_counter() - t_svd
        T[j] = self._place(flip_flow(U, 2))
        T[j + 1] = self._place(flip_flow(V, 0))
        return lam, err, svd_dt, dinfo

    def _graph_stats(self) -> Dict[str, float]:
        return self._engine.graphs.stats() if self._engine is not None else {}

    def _flop_counters(self):
        engine = self._engine
        return (engine.flops_list, engine.backend_flops["csr"]) if engine is not None else (0.0, 0.0)

    def sweep(self, max_bond: int, cutoff: float = 1e-12, resume: Optional[Dict] = None,
              on_site: Optional[Callable[[Optional[Dict]], None]] = None) -> SweepStats:
        """One full left-to-right + right-to-left sweep; returns stats.

        ``resume`` restarts mid-sweep from a state dict that ``on_site`` was
        handed (phase, next site, partial accumulators); with the restored
        MPS and environments it continues an interrupted sweep with the
        uninterrupted run's energies (``core/checkpoint.py``).
        ``on_site(state)`` is called after every site update (pair
        optimization and environment extension) with the state that
        restarts right after it, or ``None`` when the sweep has finished.
        The ``sweep.kill`` fault point fires after ``on_site``, so a test
        can checkpoint site k and die before site k+1.  The flop, graph,
        launch and memory counters of a resumed sweep cover its resumed
        part only.
        """
        n = self.n
        r = resume or {}
        energies: List[float] = list(r.get("energies", []))
        site_secs: List[float] = list(r.get("site_seconds", []))
        max_err = float(r.get("max_err", 0.0))
        svd_secs = float(r.get("svd_seconds", 0.0))
        env_secs = float(r.get("env_seconds", 0.0))
        secs_base = float(r.get("seconds", 0.0))
        dav = dict(solves=0, converged=0, iterations=0, restarts=0, exhausted=0)
        dav.update(r.get("davidson", {}))
        pair_retries = int(r.get("pair_retries", 0))
        phase = r.get("phase", "LR")
        start_j = int(r.get("j", 0 if phase == "LR" else n - 2))
        engine = self._engine
        flops0 = self._flop_counters()
        counts0 = dict(engine.backend_counts) if engine is not None else {}
        buckets0 = engine.buckets if engine is not None else 0
        work0 = dict(plan_mod.WORK_LISTS)
        graphs0 = self._graph_stats()
        launches0 = dict(kernels.VARIANT_LAUNCHES["block_gemm"])
        t0 = time.perf_counter()

        def _site(j: int, absorb: str):
            nonlocal max_err, svd_secs, env_secs, pair_retries
            ts = time.perf_counter()
            before = engine.retries.get("pair", 0) if engine is not None else 0
            lam, err, svd_dt, dinfo = self._optimize_pair(j, max_bond, cutoff, absorb)
            if engine is not None:
                pair_retries += engine.retries.get("pair", 0) - before
            te = time.perf_counter()
            if absorb == "right":
                self.left_envs[j + 1] = self._place(self._extend_left_env(j))
            else:
                self.right_envs[j] = self._place(self._extend_right_env(j))
            env_secs += time.perf_counter() - te
            energies.append(lam)
            site_secs.append(time.perf_counter() - ts)
            max_err = max(max_err, err)
            svd_secs += svd_dt
            dav["solves"] += 1
            dav["converged"] += int(dinfo.converged)
            dav["iterations"] += dinfo.iterations
            dav["restarts"] += dinfo.restarts
            dav["exhausted"] += int(dinfo.exhausted)

        def _after_site(state: Optional[Dict]):
            if on_site is not None:
                if state is not None:
                    state.update(
                        energies=list(energies), site_seconds=list(site_secs), max_err=max_err,
                        svd_seconds=svd_secs, env_seconds=env_secs, seconds=secs_base + time.perf_counter() - t0,
                        davidson=dict(dav), pair_retries=pair_retries,
                    )
                on_site(state)
            if faults.fire("sweep.kill") is not None:
                raise FaultInjected("sweep.kill", "sweep killed after a site update")

        if phase == "LR":
            for j in range(start_j, n - 1):  # left -> right
                _site(j, "right")
                _after_site({"phase": "LR", "j": j + 1} if j + 1 < n - 1 else {"phase": "RL", "j": n - 2})
            start_j = n - 2
        for j in range(start_j, -1, -1):  # right -> left
            _site(j, "left")
            _after_site({"phase": "RL", "j": j - 1} if j > 0 else None)

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the sweep's time includes its last kernels
        flops1 = self._flop_counters()
        graphs1 = self._graph_stats()
        return SweepStats(
            energy=energies[-1],
            max_bond=self.mps.max_bond(),
            trunc_err=max_err,
            seconds=secs_base + time.perf_counter() - t0,
            site_seconds=site_secs,
            site_energies=energies,
            svd_seconds=svd_secs,
            env_seconds=env_secs,
            davidson_solves=dav["solves"],
            davidson_converged=dav["converged"],
            davidson_iterations=dav["iterations"],
            davidson_restarts=dav["restarts"],
            davidson_exhausted=dav["exhausted"],
            flops_list=flops1[0] - flops0[0],
            flops_csr=flops1[1] - flops0[1],
            backend_counts={k: c - counts0[k] for k, c in engine.backend_counts.items()} if engine is not None else {},
            buckets=engine.buckets - buckets0 if engine is not None else 0,
            work_lists=plan_mod.WORK_LISTS["calls"] - work0["calls"],
            work_list_ms=plan_mod.WORK_LISTS["ms"] - work0["ms"],
            graphs={k: v if k in ("pool_bytes", "buffer_bytes", "graphs") else v - graphs0[k] for k, v in graphs1.items()},
            block_gemm_launches={
                k: n - launches0[k] for k, n in kernels.VARIANT_LAUNCHES["block_gemm"].items()
            },
            peak_bytes=torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0,
            pair_retries=pair_retries,
        )
