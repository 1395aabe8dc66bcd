"""Contraction plans: the static, cacheable half of a block-sparse contraction.

Everything the list and csr algorithms derive from quantum numbers — the
(lhs, rhs) -> out block-pair table, output indices and charge, output block
shapes, and the csr backend's packed-batch layout — is a pure function of
``(a.indices, a.charge, a block keys, b.indices, b.charge, b block keys,
axes)``.  A ``ContractionPlan`` computes it once and a ``PlanCache`` keyed by
that structural signature reuses it for the whole sweep (the analogue of
CTF's one-time output-sparsity precomputation, paper Sec. IV-B).  Plans hold
Python/numpy metadata; the csr layout also memoizes its index tables on each
device it has run on.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.block_gemm.ops import segments
from ..kernels.block_gemm.work import WorkList, work_list
from ..tensor.blocksparse import BlockKey, BlockSparseTensor
from ..tensor.qn import Charge, Index, qadd

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


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


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

    @property
    def work(self) -> WorkList:
        """The block GEMM kernel's work list of this layout, built once."""
        if self._work is None:
            self._work = work_list(self.seg, self.extents, self.bm, self.bk, self.bn)
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
    _csr: Optional[CsrLayout] = None

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

    def out_block_shape(self, kc: BlockKey) -> Tuple[int, ...]:
        return tuple(ix.sector_dim(s) for ix, s in zip(self.out_indices, kc))


class PlanCache:
    """LRU cache of ContractionPlans keyed by structural signature.

    ``hits``/``misses``/``evictions`` count lookups and capacity evictions.
    """

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self._plans: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, a: BlockSparseTensor, b: BlockSparseTensor, axes: Axes) -> ContractionPlan:
        sig = plan_signature(a, b, axes)
        plan = self._plans.get(sig)
        if plan is not None:
            self.hits += 1
            self._plans.move_to_end(sig)
            return plan
        self.misses += 1
        plan = ContractionPlan.build(a, b, axes)
        self._plans[sig] = plan
        while len(self._plans) > self.maxsize:
            self._plans.popitem(last=False)
            self.evictions += 1
        return plan

    def __len__(self) -> int:
        return len(self._plans)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions, "size": len(self._plans)}
