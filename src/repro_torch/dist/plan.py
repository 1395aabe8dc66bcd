"""Contraction, decomposition and environment plans: the static, cacheable half.

Everything the list, csr and batched backends derive from quantum numbers —
the (lhs, rhs) -> out block-pair table, output indices and charge, output
block shapes, the csr backend's packed-batch layout and the batched
backend's shape buckets — is a pure function of ``(a.indices, a.charge, a
block keys, b.indices, b.charge, b block keys, axes)``.  A
``ContractionPlan`` computes it once and a ``PlanCache`` keyed by that
structural signature reuses it for the whole sweep (the analogue of CTF's
one-time output-sparsity precomputation, paper Sec. IV-B).

The same split applies to the blockwise truncated SVD (paper Fig. 1e): a
``DecompositionPlan`` precomputes sector grouping, row/column layouts and
the gather tables that assemble each power-of-two padded sector-matrix
stack, cached in a ``DecompPlanCache`` by ``decomp_signature``; execution
lives in ``dist/decomp.py``.  And to the environment stage (paper Fig. 1d):
an ``EnvironmentPlan`` chains the three per-site contraction plans of
``extend_left`` / ``extend_right``, cached in an ``EnvPlanCache`` by the
composite ``env_signature``; execution lives in ``dist/envcore.py``.

Plans hold Python/numpy metadata.  The csr and batched layouts, and the
decomposition buckets, also memoize their index tables on each device they
have run on, so a CUDA graph captured over them reads tables uploaded
before the capture.  Those device tables belong to the process that
uploaded them: pickling a plan (``dist/persist.py``) strips them, and the
loading process uploads them again at first use.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.block_gemm.ops import segments
from ..kernels.block_gemm.work import WorkList, shared_work_list, work_list
from ..tensor.blocksparse import BlockKey, BlockSparseTensor
from ..tensor.qn import Charge, Index, qadd, qscale, qzero

PlanSignature = Tuple
Axes = Tuple[Tuple[int, ...], Tuple[int, ...]]


def plan_signature(a: BlockSparseTensor, b: BlockSparseTensor, axes: Axes) -> PlanSignature:
    """Structural signature of a contraction: indices, charges, keys, axes.

    Two contractions with equal signatures have the same pair table and
    output blocks, whatever their numeric contents.
    """
    return (
        a.indices, a.charge, tuple(sorted(a.blocks)),
        b.indices, b.charge, tuple(sorted(b.blocks)),
        tuple(axes[0]), tuple(axes[1]),
    )


# Host time of the block GEMM work lists built here (a new csr layout, a new
# bucket, a new folded batch size), process-wide: calls and milliseconds.
# A sweep reports their growth (SweepStats.work_lists, work_list_ms).
WORK_LISTS = {"calls": 0, "ms": 0.0}


def _timed_work(build, *args) -> WorkList:
    t0 = time.perf_counter()
    try:
        return build(*args)
    finally:
        WORK_LISTS["calls"] += 1
        WORK_LISTS["ms"] += (time.perf_counter() - t0) * 1e3


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def bucket_dim(d: int) -> int:
    """Round a dimension up to the next power of two (shape-bucket size)."""
    p = 1
    while p < d:
        p *= 2
    return p


def svd_flop_estimate(rp: int, cp: int) -> float:
    """~LAPACK gesdd flop estimate for one [rp, cp] economy SVD: the
    decomposition cost model (``DecompositionPlan.svd_flops``, the
    randomized-vs-exact choice of ``dist/decomp.py``)."""
    kp = min(rp, cp)
    return 8.0 * rp * cp * kp + 9.0 * kp**3


@dataclasses.dataclass
class CsrLayout:
    """Packed-batch layout of the csr backend (see tensor/block_csr.py)."""

    a_keys: Tuple[BlockKey, ...]          # participating lhs keys, pack order
    b_keys: Tuple[BlockKey, ...]          # participating rhs keys, pack order
    bm: int                               # padded matricized row dim
    bk: int                               # padded contracted dim
    bn: int                               # padded matricized col dim
    li: np.ndarray                        # [P] lhs pack slot per pair
    ri: np.ndarray                        # [P] rhs pack slot per pair
    oi: np.ndarray                        # [P] output slot per pair (sorted)
    seg: np.ndarray                       # [O+1] int32 pair segment per output
    extents: np.ndarray                   # [P, 3] int32 true (rows, depth, cols)
    out_keys: Tuple[BlockKey, ...]        # output key per output slot
    out_rc: Tuple[Tuple[int, int], ...]   # unpadded (rows, cols) per out slot
    dev_idx: Dict = dataclasses.field(default_factory=dict)
    _work: Optional[WorkList] = None

    def __getstate__(self):
        return {**self.__dict__, "dev_idx": {}}

    @property
    def work(self) -> WorkList:
        """The block GEMM kernel's work list of this layout, built once."""
        if self._work is None:
            self._work = _timed_work(work_list, self.seg, self.extents, self.bm, self.bk, self.bn)
        return self._work

    def device_tables(self, device: torch.device):
        """(li, ri, extents) on ``device``, uploaded once per device."""
        tables = self.dev_idx.get(device)
        if tables is None:
            tables = (
                torch.from_numpy(self.li.astype(np.int64)).to(device),
                torch.from_numpy(self.ri.astype(np.int64)).to(device),
                torch.from_numpy(self.extents).to(device),
            )
            self.dev_idx[device] = tables
        return tables


@dataclasses.dataclass
class ShapeBucket:
    """All block pairs of a contraction sharing one matricized (M, K, N).

    Every lhs block in the bucket matricizes to exactly (m, k) and every rhs
    block to (k, n) — no padding — so the bucket executes as ONE stacked
    block GEMM with a segment sum over its output slots (the fused
    same-shape batches of Menczer et al., arXiv:2407.07411).
    """

    m: int
    k: int
    n: int
    a_keys: Tuple[BlockKey, ...]          # unique participating lhs keys
    b_keys: Tuple[BlockKey, ...]          # unique participating rhs keys
    li: np.ndarray                        # [P] lhs slot per pair
    ri: np.ndarray                        # [P] rhs slot per pair
    oi: np.ndarray                        # [P] output slot per pair, ascending
    out_keys: Tuple[BlockKey, ...]        # bucket-local output key per slot
    li_identity: bool = False             # li == arange(P): gather is a no-op
    ri_identity: bool = False
    _work: Optional[WorkList] = None
    _folded: Dict[int, WorkList] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def work(self) -> WorkList:
        """The block GEMM kernel's work list of this bucket, built once (no
        extents: a bucket has no padding inside it) and shared with every
        bucket of the same segments and shape."""
        if self._work is None:
            self._work = _timed_work(shared_work_list, segments(self.oi, len(self.out_keys)), self.m, self.k,
                                     self.n)
        return self._work

    def folded_oi(self, batch: int) -> np.ndarray:
        """Output slots of the bucket with ``batch`` problems folded into its
        pair axis: pair ``b*P + p`` writes slot ``oi[p] + b*O``, so the table
        stays ascending (b-major) over ``batch * O`` slots."""
        O = len(self.out_keys)
        return (self.oi[None, :] + O * np.arange(batch, dtype=np.int32)[:, None]).reshape(-1).astype(np.int32)

    def folded_work(self, batch: int) -> WorkList:
        """The work list of ``folded_oi(batch)``, shape ``(batch*P,
        batch*O, m, k, n)``; built once per batch size and kept on the
        bucket (``batch == 1`` is ``work``)."""
        if batch == 1:
            return self.work
        wl = self._folded.get(batch)
        if wl is None:
            seg = segments(self.folded_oi(batch), batch * len(self.out_keys))
            wl = self._folded[batch] = _timed_work(shared_work_list, seg, self.m, self.k, self.n)
        return wl


@dataclasses.dataclass
class BatchedLayout:
    """Shape-group table: the pair list bucketed by matricized (M, K, N)."""

    buckets: Tuple[ShapeBucket, ...]
    num_unique: int                       # sum over buckets of |a_keys|+|b_keys|
    num_out_slots: int                    # sum over buckets of |out_keys|
    dev_idx: Dict = dataclasses.field(default_factory=dict)
    _host: Dict = dataclasses.field(default_factory=dict)  # per batch: every bucket's oi end to end, as uploaded

    def __getstate__(self):
        return {**self.__dict__, "dev_idx": {}, "_host": {}}

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def device_tables(self, device: torch.device, batch: int = 1):
        """Per bucket ``oi`` as an int32 tensor on ``device`` (the output
        slots the block GEMM's plain version scatters to; the kernel reads
        the bucket's work list), uploaded once per device in one copy
        without a host sync (the counterpart of the reference's per-mesh
        ``memo_dev_idx``).  With ``batch`` problems folded into the pair
        axis, each bucket's ``folded_oi(batch)``."""
        tables = self.dev_idx.get((device, batch))
        if tables is None:
            host = [b.oi if batch == 1 else b.folded_oi(batch) for b in self.buckets]
            # the concatenation is kept until the non-blocking copy is done
            self._host[batch] = flat_host = np.concatenate(host)
            flat = torch.from_numpy(flat_host).to(device, non_blocking=True)
            tables = self.dev_idx[(device, batch)] = tuple(flat.split([len(h) for h in host]))
        return tables


@dataclasses.dataclass
class ContractionPlan:
    """Precomputed symbolic structure of one block-sparse contraction."""

    signature: PlanSignature
    ax_a: Tuple[int, ...]
    ax_b: Tuple[int, ...]
    keep_a: Tuple[int, ...]
    keep_b: Tuple[int, ...]
    out_indices: Tuple[Index, ...]
    out_charge: Charge
    # (ka, kb, kc) per multiplied block pair, in the block-dict insertion
    # order of the tensors the plan was built from (the order ``contract``
    # iterates)
    pairs: Tuple[Tuple[BlockKey, BlockKey, BlockKey], ...]
    out_keys: Tuple[BlockKey, ...]        # unique output keys, first-seen order
    flops_list: float                     # sum over pairs of 2*M*K*N
    flops_dense: float                    # one dense tensordot over the full dims
    num_in_blocks: int = 0                # len(a.blocks) + len(b.blocks)
    _csr: Optional[CsrLayout] = None
    _batched: Optional[BatchedLayout] = None
    _dense_out_slices: Optional[Tuple[Tuple[BlockKey, Tuple[slice, ...]], ...]] = None

    @staticmethod
    def build(a: BlockSparseTensor, b: BlockSparseTensor, axes: Axes) -> "ContractionPlan":
        ax_a, ax_b = tuple(axes[0]), tuple(axes[1])
        if len(ax_a) != len(ax_b):
            raise ValueError(f"axes of unequal length: {axes}")
        for ia, ib in zip(ax_a, ax_b):
            if not a.indices[ia].can_contract(b.indices[ib]):
                raise ValueError(
                    f"mode {ia} of A cannot contract mode {ib} of B: "
                    f"{a.indices[ia]} vs {b.indices[ib]}"
                )
        keep_a = tuple(i for i in range(a.ndim) if i not in ax_a)
        keep_b = tuple(i for i in range(b.ndim) if i not in ax_b)
        out_indices = tuple(a.indices[i] for i in keep_a) + tuple(b.indices[i] for i in keep_b)

        b_by_sig: Dict[Tuple[int, ...], List[BlockKey]] = {}
        for kb in b.blocks:
            b_by_sig.setdefault(tuple(kb[i] for i in ax_b), []).append(kb)
        pairs: List[Tuple[BlockKey, BlockKey, BlockKey]] = []
        out_keys: List[BlockKey] = []
        seen = set()
        flops_list = 0.0
        for ka in a.blocks:
            for kb in b_by_sig.get(tuple(ka[i] for i in ax_a), ()):
                kc = tuple(ka[i] for i in keep_a) + tuple(kb[i] for i in keep_b)
                if kc not in seen:
                    seen.add(kc)
                    out_keys.append(kc)
                pairs.append((ka, kb, kc))
                m = _prod(a.indices[i].sector_dim(ka[i]) for i in keep_a)
                k = _prod(a.indices[i].sector_dim(ka[i]) for i in ax_a)
                n = _prod(b.indices[i].sector_dim(kb[i]) for i in keep_b)
                flops_list += 2.0 * m * k * n
        dense_m = _prod(a.indices[i].dim for i in keep_a)
        dense_k = _prod(a.indices[i].dim for i in ax_a)
        dense_n = _prod(b.indices[i].dim for i in keep_b)
        return ContractionPlan(
            signature=plan_signature(a, b, axes),
            ax_a=ax_a,
            ax_b=ax_b,
            keep_a=keep_a,
            keep_b=keep_b,
            out_indices=out_indices,
            out_charge=qadd(a.charge, b.charge),
            pairs=tuple(pairs),
            out_keys=tuple(out_keys),
            flops_list=flops_list,
            flops_dense=2.0 * dense_m * dense_k * dense_n,
            num_in_blocks=len(a.blocks) + len(b.blocks),
        )

    @staticmethod
    def _mshape(indices: Tuple[Index, ...], key: BlockKey, keep, ax) -> Tuple[int, int]:
        rows = _prod([indices[i].sector_dim(key[i]) for i in keep] or [1])
        cols = _prod([indices[i].sector_dim(key[i]) for i in ax] or [1])
        return rows, cols

    def _build_csr(self) -> CsrLayout:
        """Padded-batch layout, from the structural signature alone."""
        a_indices, _, a_keys_sorted, b_indices, _, b_keys_sorted = self.signature[:6]
        a_pos = {k: i for i, k in enumerate(a_keys_sorted)}
        b_pos = {k: i for i, k in enumerate(b_keys_sorted)}
        out_pos = {k: i for i, k in enumerate(self.out_keys)}
        trip = sorted(
            ((a_pos[ka], b_pos[kb], out_pos[kc]) for ka, kb, kc in self.pairs),
            key=lambda t: t[2],
        )
        part_a = sorted({t[0] for t in trip})
        part_b = sorted({t[1] for t in trip})
        a_shape = {i: self._mshape(a_indices, a_keys_sorted[i], self.keep_a, self.ax_a) for i in part_a}
        # rhs matricizes as (contracted rows, kept cols)
        b_shape = {i: self._mshape(b_indices, b_keys_sorted[i], self.ax_b, self.keep_b) for i in part_b}
        bm = max(s[0] for s in a_shape.values())
        bk = max(max(s[1] for s in a_shape.values()), max(s[0] for s in b_shape.values()))
        bn = max(s[1] for s in b_shape.values())
        a_remap = {i: n for n, i in enumerate(part_a)}
        b_remap = {i: n for n, i in enumerate(part_b)}
        nk = len(self.keep_a)
        out_rc = tuple(
            (
                _prod([self.out_indices[i].sector_dim(kc[i]) for i in range(nk)] or [1]),
                _prod([self.out_indices[i].sector_dim(kc[i]) for i in range(nk, len(self.out_indices))] or [1]),
            )
            for kc in self.out_keys
        )
        oi = np.array([t[2] for t in trip], np.int32)
        return CsrLayout(
            a_keys=tuple(a_keys_sorted[i] for i in part_a),
            b_keys=tuple(b_keys_sorted[i] for i in part_b),
            bm=bm,
            bk=bk,
            bn=bn,
            li=np.array([a_remap[t[0]] for t in trip], np.int32),
            ri=np.array([b_remap[t[1]] for t in trip], np.int32),
            oi=oi,
            seg=segments(oi, len(self.out_keys)),
            extents=np.array(
                [(*a_shape[t[0]], b_shape[t[1]][1]) for t in trip], np.int32
            ).reshape(-1, 3),
            out_keys=self.out_keys,
            out_rc=out_rc,
        )

    def _build_batched(self) -> BatchedLayout:
        """Bucket the pair list by matricized (M, K, N) shape.

        Unlike the csr layout there is NO padding: pairs share a bucket only
        when their matricized shapes are exactly equal, so each bucket is one
        regular [P, M, K] x [P, K, N] batched GEMM whose products segment-sum
        into the bucket's output slots.  Different buckets may feed the same
        output block (same kept sectors, different contracted sector dims);
        the executor accumulates across buckets.
        """
        a_indices, _, _, b_indices = self.signature[:4]
        groups: Dict[Tuple[int, int, int], List[Tuple[BlockKey, BlockKey, BlockKey]]] = {}
        for ka, kb, kc in self.pairs:
            m, k = self._mshape(a_indices, ka, self.keep_a, self.ax_a)
            n = self._mshape(b_indices, kb, self.keep_b, self.ax_b)[0]
            groups.setdefault((m, k, n), []).append((ka, kb, kc))

        buckets: List[ShapeBucket] = []
        num_unique = num_out_slots = 0
        for (m, k, n), prs in sorted(groups.items()):
            prs = sorted(prs, key=lambda t: t[2])  # -> oi ascending
            a_pos: Dict[BlockKey, int] = {}
            b_pos: Dict[BlockKey, int] = {}
            o_pos: Dict[BlockKey, int] = {}
            li, ri, oi = [], [], []
            for ka, kb, kc in prs:
                li.append(a_pos.setdefault(ka, len(a_pos)))
                ri.append(b_pos.setdefault(kb, len(b_pos)))
                oi.append(o_pos.setdefault(kc, len(o_pos)))
            li, ri = np.array(li, np.int32), np.array(ri, np.int32)
            p = len(prs)
            buckets.append(ShapeBucket(
                m=m, k=k, n=n,
                a_keys=tuple(a_pos), b_keys=tuple(b_pos),
                li=li, ri=ri, oi=np.array(oi, np.int32),
                out_keys=tuple(o_pos),
                li_identity=len(a_pos) == p and bool((li == np.arange(p)).all()),
                ri_identity=len(b_pos) == p and bool((ri == np.arange(p)).all()),
            ))
            num_unique += len(a_pos) + len(b_pos)
            num_out_slots += len(o_pos)
        return BatchedLayout(buckets=tuple(buckets), num_unique=num_unique, num_out_slots=num_out_slots)

    @property
    def batched(self) -> BatchedLayout:
        if self._batched is None:
            self._batched = self._build_batched()
        return self._batched

    def dense_out_slices(self) -> Tuple[Tuple[BlockKey, Tuple[slice, ...]], ...]:
        """Every charge-legal output block and its slice of the dense
        result, as ``BlockSparseTensor.from_dense`` extracts them (zero
        blocks included); enumerated at the first dense execution and kept
        on the plan."""
        if self._dense_out_slices is None:
            probe = BlockSparseTensor(self.out_indices, {}, self.out_charge)
            offs = [ix.offsets() for ix in self.out_indices]
            self._dense_out_slices = tuple((k, probe._slices(k, offs)) for k in probe.valid_keys())
        return self._dense_out_slices

    @property
    def csr(self) -> CsrLayout:
        if not self.pairs:
            raise ValueError("csr layout undefined for an empty pair table")
        if self._csr is None:
            self._csr = self._build_csr()
        return self._csr

    @property
    def flops_csr(self) -> float:
        """Padded-batch csr flops: pairs * 2*BM*BK*BN (builds the layout)."""
        if not self.pairs:
            return 0.0
        L = self.csr
        return 2.0 * len(self.pairs) * L.bm * L.bk * L.bn

    @property
    def num_pairs(self) -> int:
        return len(self.pairs)

    def materialize(self, pair_overhead: float = 16384.0) -> "ContractionPlan":
        """Derive the lazy layouts a run would build anyway, for the plan
        store (the reference's): the batched layout always, the dense
        output slices only where the cost model could choose dense (at the
        engine's default dispatch charge)."""
        if self.pairs:
            _ = self.batched
        if self.flops_dense <= self.flops_list + pair_overhead * self.num_pairs:
            self.dense_out_slices()
        return self

    def out_block_shape(self, kc: BlockKey) -> Tuple[int, ...]:
        return tuple(ix.sector_dim(s) for ix, s in zip(self.out_indices, kc))




# ------------------------------------------------------------ decomposition
def decomp_signature(theta: BlockSparseTensor, n_row_modes: int) -> PlanSignature:
    """Structural signature of a blockwise SVD split: everything a
    ``DecompositionPlan`` precomputes is a pure function of it."""
    return (theta.indices, theta.charge, tuple(sorted(theta.blocks)), n_row_modes)


@dataclasses.dataclass
class SectorSplit:
    """Row/column layout of one fused-charge sector of the matricized theta.

    The sector matrix is ``[R, C]``: rows are the concatenation (in
    ``row_keys`` order) of the matricized row-mode blocks, columns likewise
    for the column modes.
    """

    q: Charge
    row_keys: Tuple[BlockKey, ...]       # sorted row-part keys
    col_keys: Tuple[BlockKey, ...]       # sorted col-part keys
    rdims: Tuple[int, ...]               # matricized row dim per row key
    cdims: Tuple[int, ...]               # matricized col dim per col key
    roffs: Tuple[int, ...]               # row offset per row key
    coffs: Tuple[int, ...]               # col offset per col key
    R: int                               # total (unpadded) rows
    C: int                               # total (unpadded) cols
    bucket: int = -1                     # index into plan.buckets
    slot: int = -1                       # stack position within the bucket

    @property
    def K(self) -> int:
        """True rank bound min(R, C): number of real singular values."""
        return min(self.R, self.C)


@dataclasses.dataclass
class SvdBucket:
    """All sectors sharing one padded matrix shape (Rp, Cp).

    The bucket executes as ONE batched ``torch.linalg.svd`` over the stacked
    ``[S, Rp, Cp]`` sector matrices, assembled with a single gather from the
    flattened theta blocks (``gather`` indexes into the flat concatenation;
    the one-past-the-end slot reads an appended zero, so structural zeros
    and padding both land there).
    """

    rp: int                              # padded rows (bucket_dim(R))
    cp: int                              # padded cols (bucket_dim(C))
    sectors: Tuple[int, ...]             # indices into plan.sectors, stack order
    gather: np.ndarray                   # [S, rp, cp] int32 into the flat theta
    k_true: np.ndarray                   # [S] int32: min(R, C) per sector
    rmax: int = 0                        # largest true R and C of its sectors
    cmax: int = 0
    dev: Dict = dataclasses.field(default_factory=dict, repr=False)

    def __getstate__(self):
        return {**self.__dict__, "dev": {}}

    @property
    def kp(self) -> int:
        """Padded singular-value count min(rp, cp) per stacked sector."""
        return min(self.rp, self.cp)

    def device_tables(self, device: torch.device):
        """(gather [S*rmax*cmax] int32, real-value mask [S, min(rmax, cmax)])
        on ``device``, uploaded once per device without a host sync.  The
        gather is trimmed to the bucket's largest true sector: rows and
        columns beyond it are padding in every sector, and an SVD does not
        need them."""
        t = self.dev.get(device)
        if t is None:
            trimmed = np.ascontiguousarray(self.gather[:, :self.rmax, :self.cmax])
            gather = torch.from_numpy(trimmed).to(device, non_blocking=True).view(-1)
            k_true = torch.from_numpy(self.k_true).to(device, non_blocking=True)
            kmax = min(self.rmax, self.cmax)
            t = self.dev[device] = (gather, torch.arange(kmax, device=device)[None, :] < k_true[:, None])
        return t


@dataclasses.dataclass
class DecompositionPlan:
    """Precomputed symbolic structure of one blockwise truncated SVD,
    executed by ``dist.decomp.DecompositionEngine``."""

    signature: PlanSignature
    n_row_modes: int
    row_ix: Tuple[Index, ...]
    col_ix: Tuple[Index, ...]
    block_order: Tuple[BlockKey, ...]    # canonical (sorted) flattening order
    block_offsets: Tuple[int, ...]       # flat offset per block, same order
    nnz: int                             # total elements across blocks
    sectors: Tuple[SectorSplit, ...]     # sorted by fused charge
    buckets: Tuple[SvdBucket, ...]
    svd_flops: float                     # full-SVD flop estimate over buckets

    @staticmethod
    def build(theta: BlockSparseTensor, n_row_modes: int) -> "DecompositionPlan":
        if not theta.blocks:
            raise ValueError("svd_split of a tensor with no blocks")
        indices = theta.indices
        row_ix, col_ix = indices[:n_row_modes], indices[n_row_modes:]

        block_order = tuple(sorted(theta.blocks))
        offsets: List[int] = []
        acc = 0
        for k in block_order:
            offsets.append(acc)
            acc += _prod(indices[i].sector_dim(s) for i, s in enumerate(k))
        nnz = acc

        # group block keys by fused row charge (flow-weighted)
        groups: Dict[Charge, List[BlockKey]] = {}
        for k in block_order:
            q = qzero(indices[0].nq)
            for ix, s in zip(row_ix, k[:n_row_modes]):
                q = qadd(q, qscale(ix.charge(s), ix.flow))
            groups.setdefault(q, []).append(k)

        def layout(keys, ixs):
            dims = tuple(_prod([ix.sector_dim(s) for ix, s in zip(ixs, key)] or [1]) for key in keys)
            offs = tuple(int(o) for o in np.concatenate([[0], np.cumsum(dims)[:-1]]))
            return dims, offs, sum(dims)

        sectors: List[SectorSplit] = []
        sector_keys: List[List[BlockKey]] = []
        for q, keys in sorted(groups.items()):
            row_keys = tuple(sorted({k[:n_row_modes] for k in keys}))
            col_keys = tuple(sorted({k[n_row_modes:] for k in keys}))
            rdims, roffs, R = layout(row_keys, row_ix)
            cdims, coffs, C = layout(col_keys, col_ix)
            sectors.append(SectorSplit(q, row_keys, col_keys, rdims, cdims, roffs, coffs, R, C))
            sector_keys.append(keys)

        # bucket sectors by padded (Rp, Cp); one gather table per bucket
        by_shape: Dict[Tuple[int, int], List[int]] = {}
        for si, sec in enumerate(sectors):
            by_shape.setdefault((bucket_dim(sec.R), bucket_dim(sec.C)), []).append(si)
        buckets: List[SvdBucket] = []
        svd_flops = 0.0
        key_offset = dict(zip(block_order, offsets))
        for (rp, cp), sec_ids in sorted(by_shape.items()):
            gather = np.full((len(sec_ids), rp, cp), nnz, np.int32)
            for slot, si in enumerate(sec_ids):
                sec = sectors[si]
                sec.bucket, sec.slot = len(buckets), slot
                rpos = {rk: i for i, rk in enumerate(sec.row_keys)}
                cpos = {ck: i for i, ck in enumerate(sec.col_keys)}
                for k in sector_keys[si]:
                    ri, ci = rpos[k[:n_row_modes]], cpos[k[n_row_modes:]]
                    rd, cd = sec.rdims[ri], sec.cdims[ci]
                    # a block's elements are in (row modes, col modes) C
                    # order, so the flat block reshapes to [rd, cd] directly
                    gather[slot, sec.roffs[ri]:sec.roffs[ri] + rd, sec.coffs[ci]:sec.coffs[ci] + cd] = (
                        key_offset[k] + np.arange(rd * cd, dtype=np.int32)
                    ).reshape(rd, cd)
            svd_flops += len(sec_ids) * svd_flop_estimate(rp, cp)
            buckets.append(SvdBucket(
                rp=rp, cp=cp, sectors=tuple(sec_ids), gather=gather,
                k_true=np.array([sectors[si].K for si in sec_ids], np.int32),
                rmax=max(sectors[si].R for si in sec_ids), cmax=max(sectors[si].C for si in sec_ids),
            ))

        return DecompositionPlan(
            signature=decomp_signature(theta, n_row_modes),
            n_row_modes=n_row_modes,
            row_ix=tuple(row_ix),
            col_ix=tuple(col_ix),
            block_order=block_order,
            block_offsets=tuple(offsets),
            nnz=nnz,
            sectors=tuple(sectors),
            buckets=tuple(buckets),
            svd_flops=svd_flops,
        )

    @property
    def num_sectors(self) -> int:
        return len(self.sectors)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


# ------------------------------------------------------------- environments
def env_signature(env: BlockSparseTensor, site: BlockSparseTensor, mpo: BlockSparseTensor, side: str) -> PlanSignature:
    """Composite structural signature of one environment update: the (env,
    site, MPO) triple's structure plus the sweep direction."""
    return (
        "env", side,
        env.indices, env.charge, tuple(sorted(env.blocks)),
        site.indices, site.charge, tuple(sorted(site.blocks)),
        mpo.indices, mpo.charge, tuple(sorted(mpo.blocks)),
    )


def _probe(indices: Tuple[Index, ...], charge: Charge, keys) -> BlockSparseTensor:
    """Structure-only tensor (blocks map to None): plan building and
    signatures read block *keys* only, never block values."""
    return BlockSparseTensor(indices, dict.fromkeys(keys), charge)


def _conj_probe(t: BlockSparseTensor) -> BlockSparseTensor:
    """Structural image of ``t.conj()``: dual indices, negated charge, same
    block keys."""
    return _probe(tuple(ix.dual() for ix in t.indices), qscale(t.charge, -1), t.blocks)


# the three chained contractions of extend_left / extend_right (core/env.py)
# as static axes per step, plus the final transpose
_ENV_LEFT_AXES = (((2,), (0,)), ((1, 2), (0, 2)), ((0, 1), (0, 2)))
_ENV_LEFT_PERM = (0, 2, 1)
_ENV_RIGHT_AXES = (((2,), (2,)), ((3, 1), (3, 2)), ((1, 3), (2, 1)))
_ENV_RIGHT_PERM = (2, 1, 0)


@dataclasses.dataclass
class EnvironmentPlan:
    """Precomputed symbolic structure of one fused env update: the three
    step plans of ``extend_left`` / ``extend_right`` (fetched through a
    contraction ``PlanCache``) and the final transpose, every intermediate
    block structure resolved ahead of time.  Executed by
    ``dist.envcore.EnvironmentEngine``."""

    signature: PlanSignature
    side: str                             # "left" | "right"
    steps: Tuple[ContractionPlan, ContractionPlan, ContractionPlan]
    perm: Tuple[int, ...]                 # final transpose of step-3 output
    env_keys: Tuple[BlockKey, ...]        # sorted operand keys, core arg order
    site_keys: Tuple[BlockKey, ...]
    mpo_keys: Tuple[BlockKey, ...]
    out_indices: Tuple[Index, ...]        # post-transpose env structure
    out_charge: Charge
    out_keys: Tuple[BlockKey, ...]        # post-transpose, sorted
    pre_out_keys: Tuple[BlockKey, ...]    # step-3 key per out_keys entry
    flops: float                          # sum over steps of flops_list

    @staticmethod
    def build(env, site, mpo, side: str, cache: "PlanCache") -> "EnvironmentPlan":
        if side not in ("left", "right"):
            raise ValueError(f"side must be 'left' or 'right', got {side!r}")
        bra = _conj_probe(site)
        if side == "left":
            (ax1, ax2, ax3), perm = _ENV_LEFT_AXES, _ENV_LEFT_PERM
            p1 = cache.get(env, site, ax1)
            p2 = cache.get(_probe(p1.out_indices, p1.out_charge, p1.out_keys), mpo, ax2)
            p3 = cache.get(bra, _probe(p2.out_indices, p2.out_charge, p2.out_keys), ax3)
        else:
            (ax1, ax2, ax3), perm = _ENV_RIGHT_AXES, _ENV_RIGHT_PERM
            p1 = cache.get(site, env, ax1)
            p2 = cache.get(_probe(p1.out_indices, p1.out_charge, p1.out_keys), mpo, ax2)
            p3 = cache.get(_probe(p2.out_indices, p2.out_charge, p2.out_keys), bra, ax3)
        post_to_pre = {tuple(k[p] for p in perm): k for k in p3.out_keys}
        out_keys = tuple(sorted(post_to_pre))
        return EnvironmentPlan(
            signature=env_signature(env, site, mpo, side),
            side=side,
            steps=(p1, p2, p3),
            perm=perm,
            env_keys=tuple(sorted(env.blocks)),
            site_keys=tuple(sorted(site.blocks)),
            mpo_keys=tuple(sorted(mpo.blocks)),
            out_indices=tuple(p3.out_indices[p] for p in perm),
            out_charge=p3.out_charge,
            out_keys=out_keys,
            pre_out_keys=tuple(post_to_pre[k] for k in out_keys),
            flops=p1.flops_list + p2.flops_list + p3.flops_list,
        )


# ------------------------------------------------------------------- caches
# the process-wide plan store (``dist/persist.activate_store`` sets it)
_ACTIVE_STORE = None


class _SignatureLRU:
    """LRU cache of plans keyed by structural signature.

    ``hits``/``misses``/``evictions`` count lookups and capacity evictions,
    ``builds`` the plans actually built, ``size`` the live entries.
    Subclasses provide ``get``, which calls ``_get(signature, build)``.

    Persistence (``dist/persist.py``): on a miss the cache consults its
    ``store`` (else the process-wide ``_ACTIVE_STORE``) before building, and
    writes every fresh build back, so on a primed store ``builds`` stays
    zero.  ``kind`` names the store's subdirectory.

    Thread-safe, as the reference's: the serving layer (``serve/``) looks
    plans up from the worker thread while other threads submit and read
    stats, so every lookup and counter update holds a per-cache lock.  A
    build runs inside the lock, so two racing lookups of one signature share
    one plan (and the device tables it memoizes).  An ``EnvPlanCache`` build
    takes its contraction cache's lock, never the reverse.
    """

    kind = "contraction"

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self._plans: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = self.misses = self.evictions = self.builds = 0
        self.store = None  # a PlanStore for this cache alone (None: the active one)

    def _get(self, sig, build):
        with self._lock:
            plan = self._plans.get(sig)
            if plan is not None:
                self.hits += 1
                self._plans.move_to_end(sig)
                return plan
            self.misses += 1
            store = self.store if self.store is not None else _ACTIVE_STORE
            plan = store.load_plan(self.kind, sig) if store is not None else None
            if plan is None:
                self.builds += 1
                plan = build()
                if store is not None:
                    store.save_plan(self.kind, sig, plan)
            self._plans[sig] = plan
            while len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
                self.evictions += 1
            return plan

    def __len__(self) -> int:
        return len(self._plans)

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.hits = self.misses = self.evictions = self.builds = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                    "builds": self.builds, "size": len(self._plans)}


class PlanCache(_SignatureLRU):
    """LRU cache of ContractionPlans keyed by structural signature."""

    def get(self, a: BlockSparseTensor, b: BlockSparseTensor, axes: Axes) -> ContractionPlan:
        return self._get(plan_signature(a, b, axes), lambda: ContractionPlan.build(a, b, axes))


class DecompPlanCache(_SignatureLRU):
    """LRU cache of DecompositionPlans keyed by structural signature.

    Its default size is small: a plan holds its buckets' gather tables on
    the card once it has run there (tens of MB at m=1024), and a DMRG run
    meets a new theta structure at almost every split until it converges.
    """

    kind = "decomp"

    def __init__(self, maxsize: int = 64):
        super().__init__(maxsize)

    def get(self, theta: BlockSparseTensor, n_row_modes: int) -> DecompositionPlan:
        return self._get(decomp_signature(theta, n_row_modes), lambda: DecompositionPlan.build(theta, n_row_modes))


class EnvPlanCache(_SignatureLRU):
    """LRU cache of EnvironmentPlans keyed by the composite triple signature;
    the three step plans come from ``contraction_cache``."""

    kind = "env"

    def __init__(self, maxsize: int = 4096, contraction_cache: Optional[PlanCache] = None):
        super().__init__(maxsize)
        self.contraction_cache = contraction_cache if contraction_cache is not None else PlanCache()

    def get(self, env, site, mpo, side: str) -> EnvironmentPlan:
        return self._get(
            env_signature(env, site, mpo, side),
            lambda: EnvironmentPlan.build(env, site, mpo, side, self.contraction_cache),
        )
