"""ContractionEngine: plan-cached block-sparse contraction.

The engine is callable as ``engine(a, b, axes)`` like the bare ``contract``
and returns a ``BlockSparseTensor``.  Per call it fetches (or builds) the
``ContractionPlan`` of the contraction's structural signature from its
``PlanCache`` and executes it on one of two backends:

- "list": one ``tensordot`` per block pair (paper Alg. 2);
- "csr": every participating block matricized and zero-padded into one
  packed batch per operand, then ONE launch of the segmented block GEMM
  (``kernels/block_gemm``) — the paper's sparse-sparse contraction.

Both compute the same charge-conserving contraction: output blocks agree
with ``tensor.blocksparse.contract`` to rounding.  A failure in a backend
propagates: there is no retry on another backend, so a kernel fault
surfaces where it happens.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..kernels.block_gemm.ops import block_sparse_matmul
from ..tensor.block_csr import pack_blocks
from ..tensor.blocksparse import BlockKey, BlockSparseTensor, svd_split
from .plan import Axes, ContractionPlan, PlanCache

BACKENDS = ("list", "csr")


class ContractionEngine:
    """Executes cached ContractionPlans through the "list" or "csr" backend.

    ``use_kernel=False`` makes the csr backend run the block GEMM's plain
    PyTorch version on every device (the "csr_ref" algorithm).
    ``stats()`` documents the units of every counter it reports.
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
                f"backend {backend!r} is not ported yet: the batched backend is "
                f"ROADMAP Queue 1 #5, dense and auto are #8"
            )
        self.backend = backend
        self.cache = cache if cache is not None else PlanCache()
        self.use_kernel = use_kernel
        self.backend_counts: Dict[str, int] = {k: 0 for k in BACKENDS}
        self.backend_flops: Dict[str, float] = {k: 0.0 for k in BACKENDS}
        self.backend_seconds: Dict[str, float] = {k: 0.0 for k in BACKENDS}
        self.flops_list = 0.0

    # ----------------------------------------------------------------- entry
    def __call__(self, a: BlockSparseTensor, b: BlockSparseTensor, axes: Axes) -> BlockSparseTensor:
        plan = self.cache.get(a, b, axes)
        backend = self.backend
        self.backend_counts[backend] += 1
        self.backend_flops[backend] += plan.flops_csr if backend == "csr" else plan.flops_list
        self.flops_list += plan.flops_list
        t0 = time.perf_counter()
        out = self._execute_csr(plan, a, b) if backend == "csr" else self._execute_list(plan, a, b)
        self.backend_seconds[backend] += time.perf_counter() - t0
        return out

    # -------------------------------------------------------------- backends
    def _execute_list(self, plan: ContractionPlan, a: BlockSparseTensor, b: BlockSparseTensor) -> BlockSparseTensor:
        dims = (list(plan.ax_a), list(plan.ax_b))
        out: Dict[BlockKey, torch.Tensor] = {}
        for ka, kb, kc in plan.pairs:
            piece = torch.tensordot(a.blocks[ka], b.blocks[kb], dims=dims)
            out[kc] = out[kc] + piece if kc in out else piece
        return BlockSparseTensor(plan.out_indices, out, plan.out_charge)

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
    def two_site_matvec(self, A, Wj, Wj1, B, x) -> BlockSparseTensor:
        """y = K x with K = A . W_j . W_{j+1} . B (paper Fig. 1d)."""
        t = self(A, x, ((2,), (0,)))              # (i, k, s1, s2, r)
        t = self(t, Wj, ((1, 2), (0, 2)))         # (i, s2, r, so1, k1)
        t = self(t, Wj1, ((4, 1), (0, 2)))        # (i, r, so1, so2, k2)
        return self(t, B, ((4, 1), (1, 2)))       # (i, so1, so2, i')

    def matvec_fn(self, A, Wj, Wj1, B, jit: bool = False) -> Callable[[BlockSparseTensor], BlockSparseTensor]:
        """Davidson matvec closure over the fixed operands (eager)."""
        if jit:
            raise NotImplementedError(
                "a compiled matvec is not ported yet (CUDA graphs keyed by padded "
                "structure: ROADMAP Queue 1 #5)"
            )
        return lambda x: self.two_site_matvec(A, Wj, Wj1, B, x)

    # ------------------------------------------------------------ decomp API
    def svd_split(self, theta, n_row_modes, max_bond, cutoff=1e-12, absorb="right"):
        """The blockwise truncated SVD, ``tensor.blocksparse.svd_split``."""
        return svd_split(theta, n_row_modes, max_bond, cutoff=cutoff, absorb=absorb)

    # ------------------------------------------------------------- reporting
    def stats(self) -> Dict:
        """Plan-cache, backend-dispatch, flop and wall-time counters.

        ``backend_counts``: contractions executed per backend.
        ``backend_flops``: flops each backend executed — the exact pair flops
        for "list", the padded ``P*2*BM*BK*BN`` for "csr".  ``flops_list``:
        the exact pair flops of every contraction, whatever the backend.
        ``backend_seconds``: host wall-clock per backend in seconds; on the
        card this is enqueue time, since kernels run asynchronously.
        """
        return {
            "plan_cache": self.cache.stats(),
            "backend_counts": dict(self.backend_counts),
            "backend_flops": dict(self.backend_flops),
            "backend_seconds": dict(self.backend_seconds),
            "flops_list": self.flops_list,
        }
