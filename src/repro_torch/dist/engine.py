"""ContractionEngine: plan-cached block-sparse contraction.

The engine is callable as ``engine(a, b, axes)`` like the bare ``contract``
and returns a ``BlockSparseTensor``.  Per call it fetches (or builds) the
``ContractionPlan`` of the contraction's structural signature from its
``PlanCache`` and executes it on one of three backends:

- "list": one ``tensordot`` per block pair (paper Alg. 2);
- "csr": every participating block matricized and zero-padded into one
  packed batch per operand, then ONE launch of the segmented block GEMM
  (``kernels/block_gemm``) — the paper's sparse-sparse contraction;
- "batched": the pair list bucketed by exact matricized (M, K, N), one
  block GEMM launch per bucket (``dist/batch.py``).

All compute the same charge-conserving contraction: output blocks agree
with ``tensor.blocksparse.contract`` to rounding.  ``matvec_fn(jit=True)``
replays the planned two-site matvec as one CUDA graph per padded structure
(``dist/graphs.py``); ``svd_split`` fronts the planned batched SVD
(``dist/decomp.py``) and ``env_update_left/right`` the fused environment
updates (``dist/envcore.py``).  A failure in a backend propagates: there is
no retry on another backend, so a kernel fault surfaces where it happens.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels.block_gemm.ops import block_sparse_matmul
from ..tensor.block_csr import pack_blocks
from ..tensor.blocksparse import BlockKey, BlockSparseTensor
from .batch import execute_batched, execute_pairs, matricize_lhs, matricize_rhs
from .decomp import DecompositionEngine
from .envcore import EnvironmentEngine
from .graphs import GraphCache
from .plan import Axes, ContractionPlan, PlanCache

BACKENDS = ("list", "csr", "batched")
# the contracted axes of the two-site matvec's four steps: A·x, ·W_j,
# ·W_{j+1}, ·B (core/env.matvec_two_site)
MATVEC_AXES = (((2,), (0,)), ((1, 2), (0, 2)), ((4, 1), (0, 2)), ((4, 1), (1, 2)))


def _structure(t: BlockSparseTensor):
    return t.indices, t.charge, tuple(sorted(t.blocks))


class ContractionEngine:
    """Executes cached ContractionPlans through the "list", "csr" or
    "batched" backend.

    ``use_kernel=False`` makes the csr and batched backends run the block
    GEMM's plain PyTorch version on every device (the "csr_ref" algorithm).
    ``decomp`` and ``env`` are the engine's decomposition and environment
    stages, and ``graphs`` its CUDA graph cache, shared by the jitted matvec
    and the environment stage; each is per engine, so ``stats()`` reports
    this run's counters.  ``stats()`` documents the units of every counter.
    """

    def __init__(
        self,
        backend: str = "list",
        cache: Optional[PlanCache] = None,
        *,
        use_kernel: bool = True,
    ):
        if backend not in BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet: dense and auto are ROADMAP Queue 1 #8"
            )
        self.backend = backend
        self.cache = cache if cache is not None else PlanCache()
        self.use_kernel = use_kernel
        self.graphs = GraphCache()
        self.decomp = DecompositionEngine()
        self.env = EnvironmentEngine(graphs=self.graphs)
        self.backend_counts: Dict[str, int] = {k: 0 for k in BACKENDS}
        self.backend_flops: Dict[str, float] = {k: 0.0 for k in BACKENDS}
        self.backend_seconds: Dict[str, float] = {k: 0.0 for k in BACKENDS}
        self.flops_list = 0.0

    # ----------------------------------------------------------------- entry
    def __call__(
        self, a: BlockSparseTensor, b: BlockSparseTensor, axes: Axes, *, a_mats=None, b_mats=None, plan=None
    ) -> BlockSparseTensor:
        """The contraction of ``a`` and ``b`` over ``axes``.  ``a_mats`` /
        ``b_mats`` are pre-matricized operand blocks that only the batched
        backend consumes; ``plan`` is the contraction's plan when the caller
        holds it (a graph body), else it comes from the plan cache."""
        if plan is None:
            plan = self.cache.get(a, b, axes)
        backend = self.backend
        self.backend_counts[backend] += 1
        self.backend_flops[backend] += plan.flops_csr if backend == "csr" else plan.flops_list
        self.flops_list += plan.flops_list
        t0 = time.perf_counter()
        if backend == "csr":
            out = self._execute_csr(plan, a, b)
        elif backend == "batched":
            out = execute_batched(plan, a, b, a_mats=a_mats, b_mats=b_mats, use_kernel=self.use_kernel)
        else:
            out = BlockSparseTensor(plan.out_indices, execute_pairs(plan, a.blocks, b.blocks), plan.out_charge)
        self.backend_seconds[backend] += time.perf_counter() - t0
        return out

    # -------------------------------------------------------------- backends

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
    def _fixed_operand_mats(A, Wj, Wj1, B):
        """Matricized fixed Davidson operands for the batched backend.

        The matricization axes are static per matvec step (A contracts its
        mode 2 in step 1; W_j and W_{j+1} contract modes (0, 2); B contracts
        modes (1, 2)), so these 2-D forms never depend on x's structure.
        """
        return (
            matricize_lhs(A, (0, 1), (2,)),
            matricize_rhs(Wj, (1, 3), (0, 2)),
            matricize_rhs(Wj1, (1, 3), (0, 2)),
            matricize_rhs(B, (0,), (1, 2)),
        )

    def matvec_fn(self, A, Wj, Wj1, B, jit: bool = False) -> Callable[[BlockSparseTensor], BlockSparseTensor]:
        """Davidson matvec closure over the fixed operands.

        ``jit=False`` runs it eagerly (the batched backend matricizes the
        fixed operands once, here).  ``jit=True`` replays one CUDA graph per
        structure of (A, W_j, W_{j+1}, B, x) through ``self.graphs``: the
        fixed operands are staged once per closure, x once per call, and the
        graph matricizes and contracts them (on the CPU the same pipeline
        runs eagerly).  Each graph's entry holds the four plans it reads, so
        their device tables live as long as the graph, whatever the plan
        cache evicts.
        """
        if not jit:
            mats = self._fixed_operand_mats(A, Wj, Wj1, B) if self.backend == "batched" else None
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
                mats = self._fixed_operand_mats(A_, Wj_, Wj1_, B_) if self.backend == "batched" else None
                y = self.two_site_matvec(A_, Wj_, Wj1_, B_, x_, mats=mats, plans=plans)
                return [y.blocks[k] for k in sorted(y.blocks)]

            def prepare():
                plans = self._prepare_chain(x, (A, Wj, Wj1, B), x.device)
                last = plans[-1]
                keys = tuple(sorted(last.out_keys))
                return [last.out_block_shape(k) for k in keys], (last.out_indices, last.out_charge, keys), plans

            key = ops_key + ((x.indices, x.charge, x_keys),)
            outs, (indices, charge, keys) = self.graphs.run(
                key, body, prepare, [x.blocks[k] for k in x_keys], fixed, fixed_token=token
            )
            return BlockSparseTensor(indices, dict(zip(keys, outs)), charge)

        return call

    def _prepare_chain(self, x, ops, device) -> Tuple[ContractionPlan, ...]:
        """The four step plans of ``two_site_matvec`` on x's structure, with
        their layouts' index tables and work lists on ``device`` (before a
        graph capture, which cannot copy from the host)."""
        A, Wj, Wj1, B = ops
        t, plans = x, []
        for i, axes in enumerate(MATVEC_AXES):
            a, b = (A, t) if i == 0 else (t, ops[i])
            plan = self.cache.get(a, b, axes)
            if plan.pairs and self.backend == "batched":
                plan.batched.device_tables(device)
                for bucket in plan.batched.buckets:
                    bucket.work.tables(device)
            elif plan.pairs and self.backend == "csr":
                plan.csr.device_tables(device)
                plan.csr.work.tables(device)
            t = BlockSparseTensor(plan.out_indices, dict.fromkeys(plan.out_keys), plan.out_charge)
            plans.append(plan)
        return tuple(plans)

    # ------------------------------------------------------------ decomp API
    def svd_split(self, theta, n_row_modes, max_bond, cutoff=1e-12, absorb="right"):
        """The planned blockwise truncated SVD (``dist/decomp.py``): same
        signature and return value as ``tensor.blocksparse.svd_split``,
        equal up to the per-singular-vector sign gauge."""
        return self.decomp.svd_split(theta, n_row_modes, max_bond, cutoff=cutoff, absorb=absorb)

    # --------------------------------------------------------------- env API
    def env_update_left(self, A, T, W, *, mpo_padded=None) -> BlockSparseTensor:
        """The fused left environment update (``dist/envcore.py``): equal
        to ``core.env.extend_left(A, T, W)`` block for block."""
        return self.env.update_left(A, T, W, mpo_padded=mpo_padded)

    def env_update_right(self, B, T, W, *, mpo_padded=None) -> BlockSparseTensor:
        """The fused right environment update; see ``env_update_left``."""
        return self.env.update_right(B, T, W, mpo_padded=mpo_padded)

    # ------------------------------------------------------------- reporting
    def stats(self) -> Dict:
        """Plan-cache, backend-dispatch, flop, wall-time and graph counters.

        ``backend_counts``: contractions executed per backend.
        ``backend_flops``: flops each backend executed — the exact pair flops
        for "list" and "batched", the padded ``P*2*BM*BK*BN`` for "csr".
        ``flops_list``: the exact pair flops of every contraction, whatever
        the backend.  ``backend_seconds``: host wall-clock per backend in
        seconds; on the card this is enqueue time, since kernels run
        asynchronously.  A CUDA graph runs its contractions without calling
        the engine, so with ``jit_matvec`` on the card these counters cover
        the capture of each structure, not its replays (as the reference's
        count traces, not executions).  ``graphs``: the graph
        cache (``GraphCache.stats``); ``decomp`` and ``env``: the
        decomposition and environment stages.
        """
        return {
            "plan_cache": self.cache.stats(),
            "backend_counts": dict(self.backend_counts),
            "backend_flops": dict(self.backend_flops),
            "backend_seconds": dict(self.backend_seconds),
            "flops_list": self.flops_list,
            "graphs": self.graphs.stats(),
            "decomp": self.decomp.stats(),
            "env": self.env.stats(),
        }
