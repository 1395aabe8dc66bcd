"""ContractionEngine: plan-cached block-sparse contraction.

The engine is callable as ``engine(a, b, axes)`` like the bare ``contract``
and returns a ``BlockSparseTensor``.  Per call it fetches (or builds) the
``ContractionPlan`` of the contraction's structural signature from its
``PlanCache`` and executes it on one of four backends:

- "list": one ``tensordot`` per block pair (paper Alg. 2);
- "dense": both operands embedded densely, one ``tensordot``, the
  charge-legal output blocks re-extracted (the paper's sparse-dense
  algorithm; a library GEMM, as ``jnp.tensordot`` is in the reference);
- "csr": every participating block matricized and zero-padded into one
  packed batch per operand, then ONE launch of the segmented block GEMM
  (``kernels/block_gemm``) — the paper's sparse-sparse contraction;
- "batched": the pair list bucketed by exact matricized (M, K, N), one
  block GEMM launch per bucket (``dist/batch.py``);

either fixed, or chosen per plan by the reference's flop-and-dispatch cost
model ("auto", ``choose_backend``; csr joins its candidates only with
``allow_csr``). Under a ``BlockShardPolicy`` (``dist/shard.py``) in "spmd"
mode every contraction takes the fifth backend, "spmd": the batched bucket
tables executed through the SPMD bucket GEMM (``dist/spmd.py``), the pairs
over the mesh's "row" ranks and the output columns over its "col" ranks; in
"storage" mode every operation gathers its operands first. All compute the
same charge-conserving contraction: output blocks agree with
``tensor.blocksparse.contract`` to rounding. ``matvec_fn(jit=True)``
replays the planned two-site matvec as one CUDA graph per padded structure
(``dist/graphs.py``; eagerly under an spmd policy, whose collectives a
graph cannot capture); ``svd_split`` fronts the planned batched SVD
(``dist/decomp.py``) and ``env_update_left/right`` the fused environment
updates (``dist/envcore.py``).

A backend that raises a recoverable error (``faults.RECOVERABLE``: an
injected fault or a health guard's finding) is retried down
``CONTRACTION_LADDER`` to the seed ``contract`` on the same device
(``_degraded_call``), and every recovery is counted in
``stats()["retries"]`` and ``["degradations"]``: a clean run keeps both
empty.  Any other error propagates: a block GEMM that does not build or
launch on a CUDA tensor is never replaced by a library rung.  Inside a CUDA
graph capture nothing is retried: the capture fails.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels.block_gemm.ops import block_sparse_matmul
from ..tensor.block_csr import pack_blocks
from ..tensor.blocksparse import BlockKey, BlockSparseTensor, contract
from . import persist, spmd as spmd_mod
from .batch import batch_shape, execute_batched, execute_pairs, matricize_lhs, matricize_rhs
from .decomp import DecompositionEngine
from .envcore import EnvironmentEngine
from .faults import RECOVERABLE
from .graphs import GraphCache, capturing
from .plan import Axes, ContractionPlan, PlanCache

BACKENDS = ("list", "dense", "csr", "batched")
# cost-model overhead charged per dispatched block GEMM, in equivalent flops
# (the reference's value: on small blocks the per-op dispatch dominates,
# which is why the paper's dense algorithm wins at small m, their Fig. 5)
PAIR_OVERHEAD_FLOPS = 16384.0
# the rungs a failed backend retries, those below it in this order, ending at
# the seed ``contract``; "spmd" is a rung only under an spmd-mode policy
CONTRACTION_LADDER: Tuple[str, ...] = ("spmd", "csr", "batched", "dense", "list")
# the contracted axes of the two-site matvec's four steps: A·x, ·W_j,
# ·W_{j+1}, ·B (core/env.matvec_two_site)
MATVEC_AXES = (((2,), (0,)), ((1, 2), (0, 2)), ((4, 1), (0, 2)), ((4, 1), (1, 2)))


def _structure(t: BlockSparseTensor):
    return t.indices, t.charge, tuple(sorted(t.blocks))


class ContractionEngine:
    """Executes cached ContractionPlans through the "list", "dense", "csr"
    or "batched" backend, or the "auto" cost model's choice per plan.

    ``use_kernel=False`` makes the csr and batched backends run the block
    GEMM's plain PyTorch version on every device (the "csr_ref" algorithm).
    ``allow_csr`` lets "auto" choose csr.  ``pair_overhead`` is the cost
    model's charge per dispatch.  ``decomp`` and ``env`` are the engine's
    decomposition and environment stages, and ``graphs`` its CUDA graph
    cache, shared by the jitted matvec and the environment stage; each is
    per engine, so ``stats()`` reports this run's counters.  ``policy`` is
    a ``BlockShardPolicy`` or None (the sweep sets it).  ``stats()``
    documents the units of every counter.
    """

    def __init__(
        self,
        backend: str = "auto",
        cache: Optional[PlanCache] = None,
        *,
        use_kernel: bool = True,
        allow_csr: bool = False,
        pair_overhead: float = PAIR_OVERHEAD_FLOPS,
        policy=None,
    ):
        if backend not in BACKENDS + ("auto",):
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS + ('auto',)}")
        self.backend = backend
        self.cache = cache if cache is not None else PlanCache()
        self.use_kernel = use_kernel
        self.allow_csr = allow_csr
        self.pair_overhead = pair_overhead
        self.policy = policy
        self.graphs = GraphCache()
        self.decomp = DecompositionEngine()
        self.env = EnvironmentEngine(graphs=self.graphs, use_kernel=use_kernel)
        self.backend_counts: Dict[str, int] = {k: 0 for k in BACKENDS + ("spmd",)}
        self.backend_flops: Dict[str, float] = {k: 0.0 for k in BACKENDS + ("spmd",)}
        self.backend_seconds: Dict[str, float] = {k: 0.0 for k in BACKENDS + ("spmd",)}
        self.flops_list = 0.0
        self.buckets = 0
        # the csr backend's packed operands: packs, bytes summed, the largest
        self.csr_packed = {"packs": 0, "bytes": 0, "max_bytes": 0}
        # the degradation ladders' ledger, stage-keyed: failed first attempts
        # and the rung that recovered each (the sweep's env and pair ladders
        # report here too, through note_retry / note_degradation)
        self.retries: Dict[str, int] = {}
        self.degradations: Dict[str, int] = {}

    # ------------------------------------------------------ health bookkeeping
    def note_retry(self, stage: str) -> None:
        """Record a failed first attempt at ``stage``."""
        self.retries[stage] = self.retries.get(stage, 0) + 1

    def note_degradation(self, stage: str) -> None:
        """Record that ``stage`` recovered on a lower rung."""
        self.degradations[stage] = self.degradations.get(stage, 0) + 1

    # ----------------------------------------------------------------- entry
    def __call__(
        self, a: BlockSparseTensor, b: BlockSparseTensor, axes: Axes, *, a_mats=None, b_mats=None, plan=None
    ) -> BlockSparseTensor:
        """The contraction of ``a`` and ``b`` over ``axes``.  ``a_mats`` /
        ``b_mats`` are pre-matricized operand blocks that only the batched
        backend consumes; ``plan`` is the contraction's plan when the caller
        holds it (a graph body), else it comes from the plan cache."""
        if self._storage_mode:
            a, b = self.policy.replicated(a), self.policy.replicated(b)
        if plan is None:
            plan = self.cache.get(a, b, axes)
        backend = "spmd" if self._spmd_mode else self.backend_for(plan)
        self.backend_counts[backend] += 1
        if backend in ("batched", "spmd"):
            self.buckets += plan.batched.num_buckets
        self.backend_flops[backend] += self._plan_flops(plan, backend)
        self.flops_list += plan.flops_list
        t0 = time.perf_counter()
        try:
            if backend in ("batched", "spmd"):
                out = getattr(self, f"_execute_{backend}")(plan, a, b, a_mats=a_mats, b_mats=b_mats)
            else:
                out = getattr(self, f"_execute_{backend}")(plan, a, b)
        except RECOVERABLE:
            block = next(iter(a.blocks.values()), None)
            if block is not None and (capturing(block) or batch_shape(a)):
                # a failed capture cannot be patched up: the capture fails;
                # a stacked batch has no lower rung: its caller recovers
                raise
            out = self._degraded_call(backend, plan, a, b, axes)
        self.backend_seconds[backend] += time.perf_counter() - t0
        return self.policy.place(out) if self._spmd_mode else out

    @property
    def _spmd_mode(self) -> bool:
        return self.policy is not None and self.policy.mode == "spmd"

    @property
    def _storage_mode(self) -> bool:
        return self.policy is not None and self.policy.storage_only

    def _gathered(self, *ts):
        """The operands whole on this rank: gathered under a storage-mode
        policy, as they are otherwise."""
        return tuple(self.policy.replicated(t) for t in ts) if self._storage_mode else ts

    # ------------------------------------------------------------ cost model
    def backend_for(self, plan: ContractionPlan) -> str:
        """The backend this engine runs ``plan`` on."""
        return self.backend if self.backend != "auto" else self.choose_backend(plan)

    def choose_backend(self, plan: ContractionPlan) -> str:
        """The reference's cost model, in equivalent flops: dense pays one
        GEMM over the padded full dims plus a dispatch per embedded and
        extracted block; list a GEMM dispatch per pair; batched the exact
        pair flops plus cheaper dispatches per unique operand block
        (matricize), per bucket (stack, GEMM, segment sum) and per output
        slot; csr the padded flops and one launch."""
        n_embed = plan.num_in_blocks + len(plan.out_keys)
        cost = {
            "list": plan.flops_list + self.pair_overhead * plan.num_pairs,
            "dense": plan.flops_dense + self.pair_overhead * n_embed,
        }
        if plan.num_pairs:
            L = plan.batched
            n_disp = 0.5 * L.num_unique + 2.0 * L.num_buckets + 0.25 * L.num_out_slots
            cost["batched"] = plan.flops_list + self.pair_overhead * n_disp
        if self.allow_csr and plan.num_pairs:
            cost["csr"] = plan.flops_csr + self.pair_overhead * plan.num_pairs * 0.25
        return min(cost, key=cost.get)

    @staticmethod
    def _plan_flops(plan: ContractionPlan, backend: str) -> float:
        if backend == "dense":
            return plan.flops_dense
        if backend == "csr":
            return plan.flops_csr
        return plan.flops_list

    # ---------------------------------------------------- degradation ladder
    def _degraded_call(self, failed: str, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor,
                       axes: Axes) -> BlockSparseTensor:
        """Retry a backend that raised a recoverable error on each rung
        below it in ``CONTRACTION_LADDER`` (csr only with ``allow_csr``),
        then on the seed ``contract``, whose exception propagates.  A rung
        moves on only past a recoverable error; any other propagates.  Every
        rung computes the same contraction on the operands' device, so a
        recovery changes the time, not the values."""
        self.note_retry("contraction")
        for rung in CONTRACTION_LADDER[CONTRACTION_LADDER.index(failed) + 1:]:
            if (rung == "csr" and not self.allow_csr) or (rung == "spmd" and not self._spmd_mode):
                continue
            try:
                out = getattr(self, f"_execute_{rung}")(plan, a, b)
            except RECOVERABLE:
                continue
            self.note_degradation(f"contraction_{rung}")
            return out
        out = contract(a, b, axes)
        self.note_degradation("contraction_seed")
        return out

    # -------------------------------------------------------------- backends
    def _execute_list(self, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor) -> BlockSparseTensor:
        return BlockSparseTensor(plan.out_indices, execute_pairs(plan, a.blocks, b.blocks), plan.out_charge)

    def _execute_dense(self, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor) -> BlockSparseTensor:
        dense = torch.tensordot(a.to_dense(), b.to_dense(), dims=(list(plan.ax_a), list(plan.ax_b)))
        blocks = {k: dense[sl] for k, sl in plan.dense_out_slices()}
        return BlockSparseTensor(plan.out_indices, blocks, plan.out_charge)

    def _execute_batched(self, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor, *, a_mats=None,
                         b_mats=None) -> BlockSparseTensor:
        return execute_batched(plan, a, b, a_mats=a_mats, b_mats=b_mats, use_kernel=self.use_kernel)

    def _execute_spmd(self, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor, *, a_mats=None,
                      b_mats=None) -> BlockSparseTensor:
        """The batched bucket tables through the SPMD bucket GEMM
        (``dist/spmd.py``): pairs over "row", output columns over "col", one
        all_reduce and one all_gather per bucket."""
        p = self.policy
        gemm = spmd_mod.make_spmd_gemm(p.mesh, p.row_axis, p.col_axis, use_kernel=self.use_kernel)
        return execute_batched(plan, a, b, a_mats=a_mats, b_mats=b_mats, gemm_fn=gemm)


    def pack_csr(self, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor):
        """The block GEMM's operands for this contraction: ``(lhs, rhs,
        out_idx, work, extents)`` with lhs [P, BM, BK] and rhs [P, BK, BN]
        gathered per pair, ``out_idx`` the host table, ``work`` the
        layout's kernel work list and ``extents`` its per-pair table on the
        operands' device."""
        L = plan.csr
        lhs_all = pack_blocks(a, L.a_keys, plan.keep_a, plan.ax_a, L.bm, L.bk, True)
        rhs_all = pack_blocks(b, L.b_keys, plan.keep_b, plan.ax_b, L.bk, L.bn, False)
        li, ri, ext = L.device_tables(lhs_all.device)
        return lhs_all.index_select(0, li), rhs_all.index_select(0, ri), L.oi, L.work, ext

    def _execute_csr(self, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor) -> BlockSparseTensor:
        if not plan.pairs:
            return BlockSparseTensor(plan.out_indices, {}, plan.out_charge)
        L = plan.csr
        lhs, rhs, oi, work, ext = self.pack_csr(plan, a, b)
        nbytes = lhs.nbytes + rhs.nbytes
        self.csr_packed["packs"] += 1
        self.csr_packed["bytes"] += nbytes
        self.csr_packed["max_bytes"] = max(self.csr_packed["max_bytes"], nbytes)
        out_padded = block_sparse_matmul(
            lhs, rhs, oi, len(L.out_keys), work=work, extents=ext, use_kernel=self.use_kernel
        )
        out_blocks: Dict[BlockKey, torch.Tensor] = {}
        for o, (kc, (r, c)) in enumerate(zip(L.out_keys, L.out_rc)):
            out_blocks[kc] = out_padded[o, :r, :c].reshape(plan.out_block_shape(kc))
        return BlockSparseTensor(plan.out_indices, out_blocks, plan.out_charge)

    # ------------------------------------------------------- two-site matvec
    def two_site_matvec(self, A, Wj, Wj1, B, x, mats=None, plans=None) -> BlockSparseTensor:
        """y = K x with K = A . W_j . W_{j+1} . B (paper Fig. 1d).

        ``mats`` optionally carries the pre-matricized fixed operands (A as
        lhs of step 1; W_j, W_{j+1}, B as rhs of steps 2-4); only the
        batched backend consumes them.  ``plans`` optionally carries the
        four steps' plans (``_prepare_chain``).
        """
        mA, mWj, mWj1, mB = mats if mats is not None else (None,) * 4
        p1, p2, p3, p4 = plans if plans is not None else (None,) * 4
        ax1, ax2, ax3, ax4 = MATVEC_AXES
        t = self(A, x, ax1, a_mats=mA, plan=p1)           # (i, k, s1, s2, r)
        t = self(t, Wj, ax2, b_mats=mWj, plan=p2)         # (i, s2, r, so1, k1)
        t = self(t, Wj1, ax3, b_mats=mWj1, plan=p3)       # (i, r, so1, so2, k2)
        return self(t, B, ax4, b_mats=mB, plan=p4)        # (i, so1, so2, i')

    @staticmethod
    def _fixed_operand_mats(A, Wj, Wj1, B, steps=(True,) * 4):
        """Matricized fixed Davidson operands for the batched backend, for
        the matvec steps flagged in ``steps`` (None for the others).

        The matricization axes are static per matvec step (A contracts its
        mode 2 in step 1; W_j and W_{j+1} contract modes (0, 2); B contracts
        modes (1, 2)), so these 2-D forms never depend on x's structure.
        """
        forms = (
            lambda: matricize_lhs(A, (0, 1), (2,)),
            lambda: matricize_rhs(Wj, (1, 3), (0, 2)),
            lambda: matricize_rhs(Wj1, (1, 3), (0, 2)),
            lambda: matricize_rhs(B, (0,), (1, 2)),
        )
        return tuple(form() if on else None for form, on in zip(forms, steps))

    def matvec_fn(self, A, Wj, Wj1, B, jit: bool = False) -> Callable[[BlockSparseTensor], BlockSparseTensor]:
        """Davidson matvec closure over the fixed operands.

        ``jit=False`` runs it eagerly (the batched and auto backends
        matricize the fixed operands once, here, as the reference does).
        ``jit=True`` replays one CUDA graph per structure of (A, W_j,
        W_{j+1}, B, x) through ``self.graphs``: the fixed operands are
        staged once per closure, x once per call, and the graph matricizes
        and contracts them (on the CPU the same pipeline runs eagerly).
        Under "auto" each of the four steps runs on the backend that
        ``choose_backend`` gives its plan, in the graph as eagerly; the
        graph matricizes the fixed operand of a batched step only.  Each
        graph's entry holds the four plans it reads, so their device tables
        live as long as the graph, whatever the plan cache evicts.  Stacked
        operands (``serve/stacked.py``, batched backend) run the same
        pipeline with the problem axis folded into each block GEMM launch;
        their batch size joins the graph key.

        Under a storage-mode policy the fixed operands are gathered once,
        here.  Under an spmd-mode policy the matvec runs eagerly whatever
        ``jit`` says: its bucket GEMMs issue collectives, which a CUDA graph
        cannot capture under gloo (ROADMAP Queue 3).
        """
        A, Wj, Wj1, B = self._gathered(A, Wj, Wj1, B)
        if not jit or self._spmd_mode:
            mats = (self._fixed_operand_mats(A, Wj, Wj1, B)
                    if self.backend in ("batched", "auto") or self._spmd_mode else None)
            return lambda x: self.two_site_matvec(A, Wj, Wj1, B, x, mats=mats)

        ops = (A, Wj, Wj1, B)
        op_keys = [tuple(sorted(t.blocks)) for t in ops]
        fixed = [t.blocks[k] for t, keys in zip(ops, op_keys) for k in keys]
        ops_key = ("matvec", self.backend, self.use_kernel) + tuple(_structure(t) for t in ops)
        token = object()  # names these fixed operands in the graph cache's buffer

        def call(x: BlockSparseTensor) -> BlockSparseTensor:
            x_keys = tuple(sorted(x.blocks))

            def body(fixed_views, live_views, plans):
                it = iter(fixed_views)
                A_, Wj_, Wj1_, B_ = (
                    BlockSparseTensor(t.indices, {k: next(it) for k in keys}, t.charge)
                    for t, keys in zip(ops, op_keys)
                )
                x_ = BlockSparseTensor(x.indices, dict(zip(x_keys, live_views)), x.charge)
                steps = [self.backend_for(p) == "batched" for p in plans]
                mats = self._fixed_operand_mats(A_, Wj_, Wj1_, B_, steps)
                y = self.two_site_matvec(A_, Wj_, Wj1_, B_, x_, mats=mats, plans=plans)
                return [y.blocks[k] for k in sorted(y.blocks)]

            lead = batch_shape(x)

            def prepare():
                plans = self._prepare_chain(x, (A, Wj, Wj1, B), x.device, lead)
                last = plans[-1]
                keys = tuple(sorted(last.out_keys))
                return [lead + last.out_block_shape(k) for k in keys], (last.out_indices, last.out_charge, keys), plans

            key = ops_key + ((x.indices, x.charge, x_keys), lead)
            if key not in self.graphs and persist.active_store() is not None:
                # a structure a plan store can replay before a later run
                persist.note(("matvec", self.backend, self.use_kernel, str(x.dtype).split(".")[-1],
                              tuple(persist.structure_of(t) for t in (A, Wj, Wj1, B, x))), x.device)
            outs, (indices, charge, keys) = self.graphs.run(
                key, body, prepare, [x.blocks[k] for k in x_keys], fixed, fixed_token=token
            )
            return BlockSparseTensor(indices, dict(zip(keys, outs)), charge)

        return call

    def _prepare_chain(self, x, ops, device, lead=()) -> Tuple[ContractionPlan, ...]:
        """The four step plans of ``two_site_matvec`` on x's structure, each
        with what the backend it runs on reads from the host ready: the
        layout's index tables and work lists on ``device`` (before a graph
        capture, which cannot copy from the host), those of ``lead`` =
        ``(B,)`` problems folded for a stacked x, or the dense layout's
        output slices."""
        batch = lead[0] if lead else 1
        A, Wj, Wj1, B = ops
        t, plans = x, []
        for i, axes in enumerate(MATVEC_AXES):
            a, b = (A, t) if i == 0 else (t, ops[i])
            plan = self.cache.get(a, b, axes)
            backend = self.backend_for(plan)
            if plan.pairs and backend == "batched":
                plan.batched.device_tables(device, batch)
                for bucket in plan.batched.buckets:
                    bucket.folded_work(batch).tables(device)
            elif plan.pairs and backend == "csr":
                plan.csr.device_tables(device)
                plan.csr.work.tables(device)
            elif backend == "dense":
                plan.dense_out_slices()
            t = BlockSparseTensor(plan.out_indices, dict.fromkeys(plan.out_keys), plan.out_charge)
            plans.append(plan)
        return tuple(plans)

    # ------------------------------------------------------------ decomp API
    def svd_split(self, theta, n_row_modes, max_bond, cutoff=1e-12, absorb="right"):
        """The planned blockwise truncated SVD (``dist/decomp.py``): same
        signature and return value as ``tensor.blocksparse.svd_split``,
        equal up to the per-singular-vector sign gauge.  A storage-mode
        policy gathers theta first; an spmd-mode one places U and V."""
        (theta,) = self._gathered(theta)
        U, V, svals, err = self.decomp.svd_split(theta, n_row_modes, max_bond, cutoff=cutoff, absorb=absorb)
        if self._spmd_mode:
            U, V = self.policy.place(U), self.policy.place(V)
        return U, V, svals, err

    # --------------------------------------------------------------- env API
    def env_update_left(self, A, T, W, *, mpo_padded=None) -> BlockSparseTensor:
        """The fused left environment update (``dist/envcore.py``): equal
        to ``core.env.extend_left(A, T, W)`` block for block.  Under a
        storage-mode policy the operands are gathered first; under an
        spmd-mode one the three contractions run as SPMD bucket GEMMs on the
        policy's mesh and the output is placed."""
        return self._env_update("left", A, T, W, mpo_padded)

    def env_update_right(self, B, T, W, *, mpo_padded=None) -> BlockSparseTensor:
        """The fused right environment update; see ``env_update_left``."""
        return self._env_update("right", B, T, W, mpo_padded)

    def _env_update(self, side, env, T, W, mpo_padded):
        env, T, W, mpo_padded = self._gathered(env, T, W, mpo_padded)
        fn = self.env.update_left if side == "left" else self.env.update_right
        out = fn(env, T, W, mpo_padded=mpo_padded, spmd_mesh=self.policy.mesh if self._spmd_mode else None)
        return self.policy.place(out) if self._spmd_mode else out

    # ------------------------------------------------------------- reporting
    def stats(self) -> Dict:
        """Plan-cache, backend-dispatch, flop, wall-time and graph counters.

        ``backend_counts``: contractions executed per backend.
        ``backend_flops``: flops each backend executed — the exact pair flops
        for "list" and "batched", the padded ``P*2*BM*BK*BN`` for "csr", the
        full dense GEMM's for "dense".
        ``flops_list``: the exact pair flops of every contraction, whatever
        the backend.  ``backend_seconds``: host wall-clock per backend in
        seconds; on the card this is enqueue time, since kernels run
        asynchronously.  A CUDA graph runs its contractions without calling
        the engine, so with ``jit_matvec`` on the card these counters cover
        the capture of each structure, not its replays (as the reference's
        count traces, not executions).  ``retries`` / ``degradations``:
        the ladders' ledger, stage-keyed counts of failed first attempts and
        of the rung that recovered each ("contraction_<backend>",
        "contraction_seed", "env_seed", "pair_seed"); both empty on a
        healthy run.  ``graphs``: the graph cache (``GraphCache.stats``);
        ``decomp`` and ``env``: the decomposition and environment stages.
        ``spmd``: the process-wide SPMD ledger (``dist/spmd.stats``: bucket
        GEMM calls, fallbacks, collectives, programs), and under a policy
        ``policy``: its mode, mesh, agreement reads and their mismatches,
        and the storage mode's gathers.  ``plan_builds``: plans built by
        every plan cache of the engine (the environment stage's own
        contraction cache included); zero on a primed plan store.
        """
        return {
            "plan_cache": self.cache.stats(),
            "backend_counts": dict(self.backend_counts),
            "buckets": self.buckets,
            "csr_packed": dict(self.csr_packed),
            "backend_flops": dict(self.backend_flops),
            "backend_seconds": dict(self.backend_seconds),
            "flops_list": self.flops_list,
            "retries": dict(self.retries),
            "degradations": dict(self.degradations),
            "graphs": self.graphs.stats(),
            "decomp": self.decomp.stats(),
            "env": self.env.stats(),
            "spmd": spmd_mod.stats(),
            "policy": self.policy.stats() if self.policy is not None else None,
            "plan_builds": sum(c.builds for c in (self.cache, self.decomp.cache, self.env.cache,
                                                   self.env.cache.contraction_cache)),
        }
