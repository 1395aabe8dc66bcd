"""Decomposition engine: plan-cached, shape-bucketed batched truncated SVD.

The blockwise truncated SVD across a bond (paper Fig. 1e, Sec. IV-A) splits
theta sector by sector.  The per-sector loop (``tensor.blocksparse.
svd_split``) assembles each sector matrix with one copy per block and runs
one ``torch.linalg.svd`` per sector.  Here a ``DecompositionPlan``
(``dist/plan.py``, cached by structural signature) precomputes the sector
layouts and, per *shape bucket* — all sectors whose matrices pad to the same
power-of-two ``(Rp, Cp)`` — one gather table into the flattened theta, and
``DecompositionEngine.svd_split`` executes it:

1. ``svd_core_body``: one concatenation of theta's blocks, one gather per
   bucket into its stacked sector matrices, one batched
   ``torch.linalg.svd`` per bucket (a library call, as ``jnp.linalg.svd``
   is in the reference: no TPU kernel), the padding's singular values
   masked to exact zero, the absorb scaling on the card.  The stack is the
   plan's ``[S, Rp, Cp]`` trimmed to the bucket's largest true sector
   (``rmax`` x ``cmax``): beyond it every sector is padding, which costs an
   SVD time but changes no singular triplet of a sector (the reference
   keeps the full power-of-two shape, one compile per bucket shape);
2. ``host_truncate``: the split's one read of singular values on the host
   (every bucket's at once; ``torch.linalg.svd`` on the card also syncs
   inside each call, ``scripts/svd_syncs.py``) and the global truncation,
   ties broken by (sector, position) so that the bond never exceeds
   ``max_bond``;
3. ``slice_core_body``: the retained columns and rows sliced into U and V
   blocks (views, no copies).

For sectors whose rank far exceeds ``max_bond`` a randomized SVD (sketch and
power iterations, Halko et al. 2011) computes only the top ``max_bond +
oversample`` triplets; ``method="auto"`` picks it per bucket by a flop cost
model, ``"randomized"`` wherever the sketch is below the rank of the trimmed
stack (``DecompositionEngine._bucket_methods`` states how that differs from
the reference).  A failed split retries down a ladder that ends at the
per-sector loop (``DecompositionEngine.svd_split``).

Equality: with the exact method the split equals the per-sector loop up to
the sign gauge of each singular vector — products U·V, singular values,
retained sectors and truncation error agree (``tests/test_torch_decomp.py``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..tensor.blocksparse import BlockSparseTensor, svd_split
from ..tensor.qn import IN, Index, OUT, qzero
from . import faults, persist
from .faults import RECOVERABLE, FaultInjected, NumericalHealthError
from .plan import DecompPlanCache, DecompositionPlan, svd_flop_estimate

METHODS = ("svd", "randomized", "auto")
# host syncs inside one torch.linalg.svd on the card (cuSOLVER's info checks;
# scripts/svd_syncs.py, and tests/test_torch_cuda.py holds a split to it)
SVD_SYNCS = 2
# what the SVD ladder recovers from: the faults every ladder recovers from,
# and an SVD that did not converge
SVD_RECOVERABLE = RECOVERABLE + (torch.linalg.LinAlgError,)


def _randomized_svd(mats: torch.Tensor, sketch: int, power_iters: int, seed: int):
    """Batched randomized range-finder SVD (Halko, Martinsson, Tropp 2011).

    The approximate top-``sketch`` triplets of every stacked matrix: project
    onto a random sketch, orthonormalize, refine with QR-stabilized power
    iterations, then SVD the small projected matrix.
    """
    gen = torch.Generator(device=mats.device).manual_seed(seed)
    G = torch.randn((mats.shape[-1], sketch), generator=gen, dtype=mats.dtype, device=mats.device)
    Q, _ = torch.linalg.qr(mats @ G)                       # [S, rp, l]
    mats_h = mats.conj().transpose(-1, -2)
    for _ in range(power_iters):
        Z, _ = torch.linalg.qr(mats_h @ Q)                 # [S, cp, l]
        Q, _ = torch.linalg.qr(mats @ Z)
    Ub, s, Vh = torch.linalg.svd(Q.conj().transpose(-1, -2) @ mats, full_matrices=False)
    return Q @ Ub, s, Vh


def _rsvd_flops(rp: int, cp: int, sketch: int, power_iters: int) -> float:
    """Flop estimate of one randomized SVD: sketch and power-iteration GEMMs
    (2·rp·cp·l each), QR factorizations (~2·dim·l²) and the small SVD."""
    gemms = (2.0 + 2.0 * power_iters) * 2.0 * rp * cp * sketch
    qrs = (1.0 + 2.0 * power_iters) * 2.0 * (rp + cp) * sketch**2
    return gemms + qrs + svd_flop_estimate(sketch, cp)


def svd_core_body(plan: DecompositionPlan, absorb: str, methods: Tuple[str, ...], sketch: int,
                  rsvd_power_iters: int = 2, rsvd_seed: int = 0):
    """Assembly, batched SVD, masking and absorb of every bucket.

    Input: theta's blocks in ``plan.block_order``.  Output: per bucket
    ``(U, s, Vh)`` with the padding's singular values masked to exact zero
    and the absorb scaling applied to U ("left") or Vh ("right"), and the
    concatenated singular values of all buckets (what the caller syncs).

    Stacked blocks (a leading problem axis of B) give one SVD per bucket of
    all B problems' sectors, ``[B*S, r, c]``; every output then carries the
    problem axis in front (``U [B, S, r, k]``, ``s_cat [B, total]``).
    """
    n_modes = len(plan.row_ix) + len(plan.col_ix)

    def body(blocks):
        first = blocks[0]
        lead = tuple(first.shape[: first.dim() - n_modes])
        nb = lead[0] if lead else 1
        flat = torch.cat([b.reshape(nb, -1) for b in blocks] + [first.new_zeros((nb, 1))], dim=1)
        out, s_parts = [], []
        for bi, bucket in enumerate(plan.buckets):
            gather, mask = bucket.device_tables(first.device)
            S = len(bucket.sectors)
            mats = flat.index_select(1, gather).view(nb * S, bucket.rmax, bucket.cmax)
            if methods[bi] == "rsvd":
                U, s, Vh = _randomized_svd(mats, sketch, rsvd_power_iters, rsvd_seed + bi)
            else:
                U, s, Vh = torch.linalg.svd(mats, full_matrices=False)
            # a smaller sector's padding gives ~eps values; zero them so the
            # truncation sees only the K = min(R, C) real ones
            real = mask[:, : s.shape[-1]].repeat(nb, 1)
            s = torch.where(real, s, torch.zeros((), dtype=s.dtype, device=s.device))
            if absorb == "left":
                U = U * s[:, None, :].to(U.dtype)
            elif absorb == "right":
                Vh = Vh * s[:, :, None].to(Vh.dtype)
            U, s, Vh = (t.view(lead + (S,) + tuple(t.shape[1:])) for t in (U, s, Vh))
            out.append((U, s, Vh))
            s_parts.append(s.reshape(lead + (-1,)))
        return tuple(out), torch.cat(s_parts, dim=-1)

    return body


def slice_core_body(plan: DecompositionPlan, m_q: Tuple[int, ...]):
    """Slice every retained U column, V row and singular value: views of
    the bucket outputs, in plan order, skipping sectors with ``m_q == 0``."""

    def body(bucket_out):
        u_out, v_out, s_out = [], [], []
        for si, sec in enumerate(plan.sectors):
            m = m_q[si]
            if m == 0:
                continue
            U, s, Vh = bucket_out[sec.bucket]
            Uq, Vq = U[sec.slot], Vh[sec.slot]
            s_out.append(s[sec.slot, :m])
            for rk, rd, ro in zip(sec.row_keys, sec.rdims, sec.roffs):
                shp = tuple(ix.sector_dim(sk) for ix, sk in zip(plan.row_ix, rk)) + (m,)
                u_out.append(Uq[ro:ro + rd, :m].reshape(shp))
            for ck, cd, co in zip(sec.col_keys, sec.cdims, sec.coffs):
                shp = (m,) + tuple(ix.sector_dim(sk) for ix, sk in zip(plan.col_ix, ck))
                v_out.append(Vq[:m, co:co + cd].reshape(shp))
        return tuple(u_out), tuple(v_out), tuple(s_out)

    return body


def host_truncate(plan: DecompositionPlan, s_host: np.ndarray, k_out, max_bond: int, cutoff: float):
    """Global truncation on the host-synced singular values.

    ``s_host`` is the concatenated (masked) singular-value vector of one
    ``svd_core_body`` call, ``k_out`` the per-bucket value counts.  Returns
    ``(m_q, trunc_err)``: the retained count per plan sector (ties broken by
    (sector, position)) and the sum of the squared discarded values.
    """
    sec_vals: list = [None] * plan.num_sectors
    off = 0
    for b, bucket in enumerate(plan.buckets):
        kb = k_out[b]
        for slot, si in enumerate(bucket.sectors):
            avail = min(plan.sectors[si].K, kb)
            sec_vals[si] = s_host[off + slot * kb: off + slot * kb + avail]
        off += len(bucket.sectors) * kb

    vals = np.concatenate(sec_vals)
    sec_id = np.concatenate([np.full(len(v), si, np.int64) for si, v in enumerate(sec_vals)])
    pos_id = np.concatenate([np.arange(len(v)) for v in sec_vals])
    order = np.lexsort((pos_id, sec_id, -vals))
    smax = float(vals[order[0]]) if len(order) else 1.0
    n_keep = max(1, int(min(int(max_bond), int(np.sum(vals > cutoff * smax)))))
    m_q = np.zeros(plan.num_sectors, np.int64)
    np.add.at(m_q, sec_id[order[:n_keep]], 1)
    # a direct tail sum: exactly 0.0 when nothing is truncated
    return m_q, float(np.sum(vals[order[n_keep:]] ** 2))


class DecompositionEngine:
    """Executes cached DecompositionPlans as bucketed batched SVDs.

    ``method``: "svd" (exact batched SVD, the default and the only method
    equal to the per-sector loop up to gauge), "randomized" (a randomized SVD
    on every bucket whose rank exceeds the sketch ``max_bond +
    rsvd_oversample``), or "auto" (per bucket, by flop cost).  The sketch is
    drawn from ``rsvd_seed``, so repeated calls are deterministic.
    ``stats()`` reports cumulative counters; see its docstring for units.
    """

    def __init__(
        self,
        cache: Optional[DecompPlanCache] = None,
        method: str = "svd",
        *,
        rsvd_oversample: int = 8,
        rsvd_power_iters: int = 2,
        rsvd_min_gain: float = 1.0,
        rsvd_seed: int = 0,
    ):
        if method not in METHODS:
            raise ValueError(f"unknown svd method {method!r}; one of {METHODS}")
        self.cache = cache if cache is not None else DecompPlanCache()
        self.method = method
        self.rsvd_oversample = rsvd_oversample
        self.rsvd_power_iters = rsvd_power_iters
        self.rsvd_min_gain = rsvd_min_gain
        self.rsvd_seed = rsvd_seed
        self.svd_calls = 0
        self.svd_flops = 0.0
        self.svd_seconds = 0.0
        self.sectors_processed = 0
        self.buckets_processed = 0
        self.rsvd_buckets = 0
        self.host_syncs = 0
        # reads the singular values on the host; a distributed sweep sets its
        # policy's ``host_values`` so that every rank truncates alike
        self.host = None
        # the degradation ladder's ledger: splits whose first attempt failed,
        # and the rung that recovered each; both zero on a healthy run
        self.retries = 0
        self.degradations = {"svd_exact": 0, "svd_unplanned": 0}

    # ------------------------------------------------------------ cost model
    def _bucket_methods(self, plan: DecompositionPlan, max_bond: int) -> Tuple[Tuple[str, ...], int]:
        """Per-bucket "svd"/"rsvd" choice and the sketch size.

        The randomized path only where the sketch is below the rank of the
        stack this engine runs, ``min(rmax, cmax)`` (the bucket trimmed to
        its largest true sector, see ``svd_core_body``), and under "auto"
        only where it also wins the flop comparison, priced on the padded
        ``(rp, cp)`` as the reference prices it, by ``rsvd_min_gain``x.
        This differs from the reference, which compares the sketch with the
        padded rank ``kp = min(rp, cp)``: where ``min(rmax, cmax) <= sketch
        < kp`` the reference may take the randomized SVD and this engine
        takes the exact one.  A sketch at or above the trimmed stack's rank
        costs more than the exact SVD of that stack and gives the same
        triplets, so the exact SVD is kept there
        (``tests/test_torch_decomp_choice.py`` holds both choices against
        the reference's).
        """
        sketch = max_bond + self.rsvd_oversample
        if self.method == "svd":
            return ("svd",) * plan.num_buckets, sketch
        methods = []
        for b in plan.buckets:
            if sketch >= min(b.rmax, b.cmax):
                methods.append("svd")
            elif self.method == "randomized":
                methods.append("rsvd")
            else:
                full = svd_flop_estimate(b.rp, b.cp)
                rand = _rsvd_flops(b.rp, b.cp, sketch, self.rsvd_power_iters)
                methods.append("rsvd" if rand * self.rsvd_min_gain < full else "svd")
        return tuple(methods), sketch

    def _call_flops(self, plan: DecompositionPlan, methods, sketch: int) -> float:
        return sum(
            len(b.sectors) * (
                _rsvd_flops(b.rp, b.cp, sketch, self.rsvd_power_iters) if m == "rsvd"
                else svd_flop_estimate(b.rp, b.cp)
            )
            for b, m in zip(plan.buckets, methods)
        )

    # ----------------------------------------------------------------- entry
    def svd_split(self, theta: BlockSparseTensor, n_row_modes: int, max_bond: int,
                  cutoff: float = 1e-12, absorb: str = "right"):
        """Planned blockwise truncated SVD, the signature of
        ``tensor.blocksparse.svd_split``.

        Returns ``(U, V, svals_by_sector, trunc_err)``; ``trunc_err`` (a host
        float) is the sum of the squared discarded singular values, the
        squared Frobenius error ``||theta - U·V||²`` when ``absorb`` is
        "left" or "right".  Non-finite singular values at the sync raise
        ``NumericalHealthError(stage="svd")``.

        A failed attempt (``torch.linalg.LinAlgError`` out of the batched
        SVD, an injected ``decomp.svd_fail``, or non-finite singular values
        at the sync; any other error propagates) retries down the ladder: randomized -> exact batched SVD -> the
        per-sector loop ``tensor.blocksparse.svd_split``, on the same
        device.  Each failed first attempt is counted in
        ``stats()["retries"]`` and the rung that recovered it in
        ``["degradations"]``; if the last rung fails, its exception (for a
        poisoned theta, ``NumericalHealthError``) propagates.
        """
        t0 = time.perf_counter()
        try:
            plan = self.cache.get(theta, n_row_modes)
            methods, sketch = self._bucket_methods(plan, int(max_bond))
            try:
                if faults.fire("decomp.svd_fail") is not None:
                    raise FaultInjected("decomp.svd_fail", "batched SVD did not converge")
                return self._execute(plan, theta, max_bond, cutoff, absorb, methods, sketch)
            except SVD_RECOVERABLE:
                # the ladder: randomized -> exact batched -> per-sector loop,
                # every rung on theta's device; the last rung's error propagates
                self.retries += 1
                if "rsvd" in methods:
                    try:
                        out = self._execute(plan, theta, max_bond, cutoff, absorb,
                                            ("svd",) * plan.num_buckets, sketch)
                    except SVD_RECOVERABLE:
                        pass
                    else:
                        self.degradations["svd_exact"] += 1
                        return out
                out = svd_split(theta, n_row_modes, max_bond, cutoff=cutoff, absorb=absorb)
                self.degradations["svd_unplanned"] += 1
                return out
        finally:
            self.svd_seconds += time.perf_counter() - t0

    def record_call(self, plan: DecompositionPlan, methods, sketch: int, on_card: bool, problems: int = 1) -> None:
        """Count one executed split of ``plan`` (of ``problems`` stacked
        problems) in the stats: its host syncs are those of one split
        whatever the batch, one read of every singular value and
        ``SVD_SYNCS`` per bucket."""
        self.svd_calls += 1
        self.svd_flops += problems * self._call_flops(plan, methods, sketch)
        self.sectors_processed += problems * plan.num_sectors
        self.buckets_processed += plan.num_buckets
        self.rsvd_buckets += sum(1 for m in methods if m == "rsvd")
        if on_card:
            self.host_syncs += 1 + SVD_SYNCS * plan.num_buckets

    def _execute(self, plan, theta, max_bond, cutoff, absorb, methods, sketch):
        core = svd_core_body(plan, absorb, methods, sketch, self.rsvd_power_iters, self.rsvd_seed)
        bucket_out, s_cat = core([theta.blocks[k] for k in plan.block_order])
        self.record_call(plan, methods, sketch, s_cat.is_cuda)
        if persist.active_store() is not None:
            # the SVD stacks a plan store warms before a later run
            for bucket, (U, s, _), method in zip(plan.buckets, bucket_out, methods):
                if method != "rsvd":
                    shape = (U.shape[:-2].numel(), bucket.rmax, bucket.cmax)
                    persist.note(("svd", str(U.dtype).split(".")[-1], shape), U.device)

        # the split's one read on the host: every bucket's singular values
        s_host = self.host(s_cat) if self.host is not None else s_cat.cpu().numpy()
        if not np.isfinite(s_host).all():
            raise NumericalHealthError("non-finite singular values at the truncation sync", stage="svd")
        k_out = [int(out[1].shape[-1]) for out in bucket_out]
        m_q, trunc_err = host_truncate(plan, s_host, k_out, max_bond, cutoff)
        m_tuple = tuple(int(x) for x in m_q)
        u_flat, v_flat, s_flat = slice_core_body(plan, m_tuple)(bucket_out)

        new_sectors, u_blocks, v_blocks, svals = [], {}, {}, {}
        ui = vi = si_out = 0
        for si, sec in enumerate(plan.sectors):
            if m_tuple[si] == 0:
                continue
            svals[sec.q] = s_flat[si_out]
            si_out += 1
            new_sectors.append((sec.q, m_tuple[si]))
            for rk in sec.row_keys:
                u_blocks[(sec.q, rk)] = u_flat[ui]
                ui += 1
            for ck in sec.col_keys:
                v_blocks[(sec.q, ck)] = v_flat[vi]
                vi += 1

        # the new bond carries the fused row charge q: IN on U, OUT on V
        bond_u = Index(tuple(new_sectors), IN, "bond")
        bond_v = Index(tuple(new_sectors), OUT, "bond")
        sector_index = {q: i for i, (q, _) in enumerate(new_sectors)}
        U_t = BlockSparseTensor(
            list(plan.row_ix) + [bond_u],
            {rk + (sector_index[q],): b for (q, rk), b in u_blocks.items()},
            qzero(theta.indices[0].nq),
        )
        V_t = BlockSparseTensor(
            [bond_v] + list(plan.col_ix),
            {(sector_index[q],) + ck: b for (q, ck), b in v_blocks.items()},
            theta.charge,
        )
        return U_t, V_t, svals, trunc_err

    # ------------------------------------------------------------- reporting
    def stats(self) -> Dict:
        """Cumulative decomposition-stage counters.

        - ``plan_cache``: the DecompPlanCache's counters.
        - ``svd_calls``: ``svd_split`` executions.
        - ``svd_flops``: estimated flops of the executed decompositions (a
          cost-model estimate, not a hardware counter).
        - ``svd_seconds``: host wall-clock per call, including the
          singular-value sync, so it covers the SVD work on the card.
        - ``sectors`` / ``buckets``: charge sectors decomposed and shape
          buckets executed (buckets <= sectors: the gap is the batching).
        - ``rsvd_buckets``: buckets that took the randomized path.
        - ``host_syncs``: host syncs with the card (0 on the CPU): per split
          one at the singular values' read and ``SVD_SYNCS`` inside each
          bucket's ``torch.linalg.svd``, so 2 x buckets + 1 (a randomized
          bucket's QR factorizations are not counted).
        - ``retries``: splits whose first attempt failed;
          ``degradations``: the rung that recovered each ("svd_exact",
          "svd_unplanned").
        """
        return {
            "plan_cache": self.cache.stats(),
            "svd_calls": self.svd_calls,
            "svd_flops": self.svd_flops,
            "svd_seconds": self.svd_seconds,
            "sectors": self.sectors_processed,
            "buckets": self.buckets_processed,
            "rsvd_buckets": self.rsvd_buckets,
            "host_syncs": self.host_syncs,
            "retries": self.retries,
            "degradations": dict(self.degradations),
        }
