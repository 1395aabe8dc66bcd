"""Two-site DMRG sweeps (paper Sec. II-C, Fig. 1c-e).

Maintains left/right environments incrementally, optimizes each neighboring
pair with Davidson on the two-site matvec, splits the result with the
blockwise truncated SVD (absorbing the singular values along the sweep
direction), and extends the environment by one site with the three chained
contractions of ``extend_left``/``extend_right``.  Every contraction goes
through the contractor of ``algo`` (``core/env.get_contractor``), eagerly.

There is no degradation ladder: a failure in a contraction, a split or an
environment update propagates, so a kernel fault surfaces where it happens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

from ..device import resolve_device
from ..dist.engine import ContractionEngine
from ..tensor.blocksparse import BlockSparseTensor, flip_flow, svd_split
from .davidson import davidson
from .env import extend_left, extend_right, get_contractor, left_edge, matvec_two_site, right_edge
from .mps import MPS


def unported(**args) -> None:
    """Raise for any argument of the reference API that this port does not
    carry yet, naming the ROADMAP item that brings it."""
    where = {
        "jit_matvec": "Queue 1 #5 (batched backend with CUDA graphs)",
        "pad_matvec": "Queue 1 #5 (batched backend with CUDA graphs)",
        "shard_policy": "Queue 1 #12 (multi-GPU)",
        "spmd": "Queue 1 #12 (multi-GPU)",
        "plan_store": "Queue 1 #11 (persistence)",
        "checkpoint_dir": "Queue 1 #9 (robustness: checkpoints)",
        "restored_envs": "Queue 1 #9 (robustness: checkpoints)",
        "svd_method": "Queue 1 #6 (planned batched decomposition)",
        "jit_env": "Queue 1 #7 (environment engine)",
    }
    for name, value in args.items():
        if name == "svd_method":
            bad = value not in (None, "unplanned")
        elif name == "pad_matvec":
            bad = bool(value)
        else:
            bad = value not in (None, False)
        if bad:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: ROADMAP {where[name]}"
            )


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
    flops_list: float = 0.0
    flops_csr: float = 0.0


class DMRGEngine:
    """Alternating two-site optimization with incremental environments.

    ``device=None`` means the CUDA card (raising when there is none); the
    MPS and MPO must already lie on the resolved device.
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
        unported(
            jit_matvec=jit_matvec, pad_matvec=pad_matvec, shard_policy=shard_policy,
            svd_method=svd_method, jit_env=jit_env, restored_envs=restored_envs,
        )
        if mps.n_sites != len(mpo):
            raise ValueError(f"MPS has {mps.n_sites} sites, MPO {len(mpo)}")
        self.device = resolve_device(device)
        for t in list(mps.tensors) + list(mpo):
            if t.device is not None and t.device.type != self.device.type:
                raise ValueError(f"tensor on {t.device}, engine on {self.device}")
        self.mps = mps
        self.mpo = mpo
        self.algo = algo
        self.contract_fn = engine if engine is not None else get_contractor(algo, self.device)
        self.davidson_iters = davidson_iters
        self.seed = seed
        self.n = mps.n_sites
        self._init_envs()

    def _init_envs(self):
        n = self.n
        T, W = self.mps.tensors, self.mpo
        self.left_envs: List[Optional[BlockSparseTensor]] = [None] * (n + 1)
        self.right_envs: List[Optional[BlockSparseTensor]] = [None] * (n + 1)
        self.left_envs[0] = left_edge(T[0], W[0])
        self.right_envs[n - 1] = right_edge(T[n - 1], W[n - 1])
        for j in range(n - 2, 0, -1):
            self.right_envs[j] = self._extend_right_env(j)

    def _extend_left_env(self, j: int) -> BlockSparseTensor:
        """A_{j+1} from A_j: absorb site j into the left environment."""
        return extend_left(self.left_envs[j], self.mps.tensors[j], self.mpo[j], self.contract_fn)

    def _extend_right_env(self, j: int) -> BlockSparseTensor:
        """B_j from B_{j+1}: absorb site j+1 into the right environment."""
        return extend_right(self.right_envs[j + 1], self.mps.tensors[j + 1], self.mpo[j + 1], self.contract_fn)

    def _optimize_pair(self, j: int, max_bond: int, cutoff: float, absorb: str):
        T, W = self.mps.tensors, self.mpo
        A, B = self.left_envs[j], self.right_envs[j + 1]
        theta = self.contract_fn(T[j], T[j + 1], ((2,), (0,)))
        if isinstance(self.contract_fn, ContractionEngine):
            mv = self.contract_fn.matvec_fn(A, W[j], W[j + 1], B)
        else:
            def mv(x):
                return matvec_two_site(A, W[j], W[j + 1], B, x, self.contract_fn)

        lam, theta, dinfo = davidson(mv, theta, n_iter=self.davidson_iters, seed=self.seed + j)
        t_svd = time.perf_counter()
        U, V, _, err = svd_split(theta, 2, max_bond=max_bond, cutoff=cutoff, absorb=absorb)
        svd_dt = time.perf_counter() - t_svd
        T[j] = flip_flow(U, 2)
        T[j + 1] = flip_flow(V, 0)
        return lam, err, svd_dt, dinfo

    def _flop_counters(self):
        if isinstance(self.contract_fn, ContractionEngine):
            return self.contract_fn.flops_list, self.contract_fn.backend_flops["csr"]
        return 0.0, 0.0

    def sweep(self, max_bond: int, cutoff: float = 1e-12) -> SweepStats:
        """One full left-to-right + right-to-left sweep; returns stats."""
        n = self.n
        energies: List[float] = []
        site_secs: List[float] = []
        max_err = svd_secs = env_secs = 0.0
        dav = dict(solves=0, converged=0, iterations=0, restarts=0, exhausted=0)
        flops0 = self._flop_counters()
        t0 = time.perf_counter()

        def _site(j: int, absorb: str):
            nonlocal max_err, svd_secs, env_secs
            ts = time.perf_counter()
            lam, err, svd_dt, dinfo = self._optimize_pair(j, max_bond, cutoff, absorb)
            te = time.perf_counter()
            if absorb == "right":
                self.left_envs[j + 1] = self._extend_left_env(j)
            else:
                self.right_envs[j] = self._extend_right_env(j)
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

        for j in range(n - 1):  # left -> right
            _site(j, "right")
        for j in range(n - 2, -1, -1):  # right -> left
            _site(j, "left")

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the sweep's time includes its last kernels
        flops1 = self._flop_counters()
        return SweepStats(
            energy=energies[-1],
            max_bond=self.mps.max_bond(),
            trunc_err=max_err,
            seconds=time.perf_counter() - t0,
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
        )
