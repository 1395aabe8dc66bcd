"""Block-sparse tensors, the *list* contraction (paper Alg. 2) and the SVD split.

A ``BlockSparseTensor`` stores one dense ``torch.Tensor`` per nonzero
quantum-number block, as the paper's list format stores "a set of memory
distributed tensor blocks T_{q^(l)}".  Block keys and ``Index`` metadata are
plain Python; the blocks live on whatever device they were made on, and every
operation keeps them there.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..dist.faults import NumericalHealthError
from .qn import Charge, IN, Index, OUT, qadd, qscale, qzero

BlockKey = Tuple[int, ...]  # sector position along each mode


class BlockSparseTensor:
    """List-format block-sparse tensor (paper Sec. IV-A, "list algorithm")."""

    def __init__(
        self,
        indices: Sequence[Index],
        blocks: Dict[BlockKey, torch.Tensor],
        charge: Charge | None = None,
    ):
        self.indices = tuple(indices)
        self.charge = charge if charge is not None else qzero(self.indices[0].nq)
        self.blocks = dict(blocks)

    # ------------------------------------------------------------------ meta
    @property
    def ndim(self) -> int:
        return len(self.indices)

    @property
    def dtype(self) -> torch.dtype:
        for b in self.blocks.values():
            return b.dtype
        return torch.float64

    @property
    def device(self) -> torch.device | None:
        for b in self.blocks.values():
            return b.device
        return None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(ix.dim for ix in self.indices)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def block_shape(self, key: BlockKey) -> Tuple[int, ...]:
        return tuple(ix.sector_dim(s) for ix, s in zip(self.indices, key))

    def key_charge(self, key: BlockKey) -> Charge:
        q = qzero(self.indices[0].nq)
        for ix, s in zip(self.indices, key):
            q = qadd(q, qscale(ix.charge(s), ix.flow))
        return q

    def valid_keys(self) -> List[BlockKey]:
        """All sector combinations consistent with the tensor charge."""
        out: List[BlockKey] = []

        def rec(i: int, q: Charge, key: BlockKey):
            if i == len(self.indices):
                if q == self.charge:
                    out.append(key)
                return
            ix = self.indices[i]
            for s in range(ix.num_sectors):
                rec(i + 1, qadd(q, qscale(ix.charge(s), ix.flow)), key + (s,))

        rec(0, qzero(self.indices[0].nq), ())
        return out

    def check(self):
        for k, b in self.blocks.items():
            if self.key_charge(k) != self.charge:
                raise ValueError(f"block {k} violates charge conservation")
            if tuple(b.shape) != self.block_shape(k):
                raise ValueError(f"block {k} shape {tuple(b.shape)} != {self.block_shape(k)}")

    # ------------------------------------------------------------- construct
    @staticmethod
    def zeros(indices, charge=None, *, dtype=torch.float64, device=None):
        t = BlockSparseTensor(indices, {}, charge)
        t.blocks = {
            k: torch.zeros(t.block_shape(k), dtype=dtype, device=device)
            for k in t.valid_keys()
        }
        return t

    @staticmethod
    def random(indices, charge=None, *, generator: torch.Generator, dtype=torch.float64):
        """Normal entries on every valid block, drawn from ``generator`` on
        the generator's own device."""
        t = BlockSparseTensor(indices, {}, charge)
        t.blocks = {
            k: torch.randn(
                t.block_shape(k), generator=generator, dtype=dtype,
                device=generator.device,
            )
            for k in t.valid_keys()
        }
        return t

    # --------------------------------------------------------------- algebra
    def scale(self, a) -> "BlockSparseTensor":
        return BlockSparseTensor(self.indices, {k: a * b for k, b in self.blocks.items()}, self.charge)

    def __add__(self, other: "BlockSparseTensor") -> "BlockSparseTensor":
        if self.indices != other.indices or self.charge != other.charge:
            raise ValueError("adding tensors of different structure")
        blocks = dict(self.blocks)
        for k, b in other.blocks.items():
            blocks[k] = blocks[k] + b if k in blocks else b
        return BlockSparseTensor(self.indices, blocks, self.charge)

    def __sub__(self, other: "BlockSparseTensor") -> "BlockSparseTensor":
        return self + other.scale(-1.0)

    def conj(self) -> "BlockSparseTensor":
        """Complex conjugate + flip all flows (bra tensor)."""
        return BlockSparseTensor(
            [ix.dual() for ix in self.indices],
            {k: torch.conj(b) for k, b in self.blocks.items()},
            qscale(self.charge, -1),
        )

    def transpose(self, perm: Sequence[int]) -> "BlockSparseTensor":
        perm = tuple(perm)
        return BlockSparseTensor(
            [self.indices[p] for p in perm],
            {tuple(k[p] for p in perm): b.permute(perm) for k, b in self.blocks.items()},
            self.charge,
        )

    def norm_sq(self):
        """Squared norm as a 0-d tensor on the blocks' device (no host sync)."""
        acc = 0.0
        for b in self.blocks.values():
            acc = acc + torch.sum(torch.abs(b) ** 2)
        return acc.real if torch.is_tensor(acc) else torch.tensor(acc)

    def norm(self):
        return torch.sqrt(self.norm_sq())

    def inner(self, other: "BlockSparseTensor"):
        """<self|other> over shared blocks, a 0-d tensor (no host sync)."""
        acc = 0.0
        for k, b in self.blocks.items():
            if k in other.blocks:
                acc = acc + torch.sum(torch.conj(b) * other.blocks[k])
        return acc if torch.is_tensor(acc) else torch.tensor(acc)

    # ------------------------------------------------------------- densify
    def _slices(self, key: BlockKey, offs) -> Tuple[slice, ...]:
        return tuple(
            slice(offs[i][s], offs[i][s] + self.indices[i].sector_dim(s))
            for i, s in enumerate(key)
        )

    def to_dense(self) -> torch.Tensor:
        """Embed blocks at sector offsets (the sparse-dense layout)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        offs = [ix.offsets() for ix in self.indices]
        for k, b in self.blocks.items():
            out[self._slices(k, offs)] = b
        return out

    @staticmethod
    def from_dense(dense: torch.Tensor, indices, charge=None) -> "BlockSparseTensor":
        t = BlockSparseTensor(indices, {}, charge)
        offs = [ix.offsets() for ix in t.indices]
        t.blocks = {k: dense[t._slices(k, offs)] for k in t.valid_keys()}
        return t


def flip_flow(t: BlockSparseTensor, axis: int) -> BlockSparseTensor:
    """Replace Index(q, flow) with Index(-q, -flow) on one mode (no-op on data).

    flow*q is invariant, so charge conservation is untouched; used to
    re-orient bond arrows after ``svd_split``.  Both sides of a bond must be
    flipped together.
    """
    ix = t.indices[axis]
    perm = sorted(range(ix.num_sectors), key=lambda s: tuple(-c for c in ix.charge(s)))
    new_ix = Index(
        tuple((tuple(-c for c in ix.charge(s)), ix.sector_dim(s)) for s in perm),
        -ix.flow,
        ix.name,
    )
    inv = {old: new for new, old in enumerate(perm)}
    blocks = {k[:axis] + (inv[k[axis]],) + k[axis + 1 :]: b for k, b in t.blocks.items()}
    indices = list(t.indices)
    indices[axis] = new_ix
    return BlockSparseTensor(indices, blocks, t.charge)


# ------------------------------------------------------------------ contract
def contract(
    a: BlockSparseTensor,
    b: BlockSparseTensor,
    axes: Tuple[Sequence[int], Sequence[int]],
) -> BlockSparseTensor:
    """Paper Algorithm 2: list-format block-sparse contraction.

    Enumerates the block pairs whose charges match along the contracted
    modes (a hash join on the contracted sector labels) and tensordots each,
    accumulating into output blocks keyed by the remaining sector labels.
    """
    ax_a, ax_b = tuple(axes[0]), tuple(axes[1])
    if len(ax_a) != len(ax_b):
        raise ValueError(f"axes of unequal length: {axes}")
    for ia, ib in zip(ax_a, ax_b):
        if not a.indices[ia].can_contract(b.indices[ib]):
            raise ValueError(
                f"mode {ia} of A cannot contract mode {ib} of B: "
                f"{a.indices[ia]} vs {b.indices[ib]}"
            )
    keep_a = [i for i in range(a.ndim) if i not in ax_a]
    keep_b = [i for i in range(b.ndim) if i not in ax_b]
    out_indices = [a.indices[i] for i in keep_a] + [b.indices[i] for i in keep_b]

    b_by_sig: Dict[Tuple[int, ...], List[BlockKey]] = {}
    for kb in b.blocks:
        b_by_sig.setdefault(tuple(kb[i] for i in ax_b), []).append(kb)

    dims = (list(ax_a), list(ax_b))
    out_blocks: Dict[BlockKey, torch.Tensor] = {}
    for ka, ablock in a.blocks.items():
        for kb in b_by_sig.get(tuple(ka[i] for i in ax_a), ()):
            kc = tuple(ka[i] for i in keep_a) + tuple(kb[i] for i in keep_b)
            piece = torch.tensordot(ablock, b.blocks[kb], dims=dims)
            out_blocks[kc] = out_blocks[kc] + piece if kc in out_blocks else piece
    return BlockSparseTensor(out_indices, out_blocks, qadd(a.charge, b.charge))


# ------------------------------------------------------------------ SVD split
def _truncate(s_by_sector: List[np.ndarray], max_bond: int, cutoff: float):
    """Global truncation across sectors with the (sector, position) tie-break.

    Keeps at most ``max_bond`` values (never more, even on exact ties), drops
    those ``<= cutoff * s_max``, keeps at least one.  Returns the kept count
    per sector and the sum of squared discarded values.
    """
    vals = np.concatenate(s_by_sector)
    sec_id = np.concatenate([np.full(len(v), i, np.int64) for i, v in enumerate(s_by_sector)])
    pos_id = np.concatenate([np.arange(len(v)) for v in s_by_sector])
    order = np.lexsort((pos_id, sec_id, -vals))
    smax = float(vals[order[0]])
    n_keep = max(1, int(min(int(max_bond), int(np.sum(vals > cutoff * smax)))))
    m_q = np.zeros(len(s_by_sector), np.int64)
    np.add.at(m_q, sec_id[order[:n_keep]], 1)
    return m_q, float(np.sum(vals[order[n_keep:]] ** 2))


def svd_split(
    theta: BlockSparseTensor,
    n_row_modes: int,
    max_bond: int,
    cutoff: float = 1e-12,
    absorb: str = "right",
):
    """Blockwise truncated SVD across a bond (paper Fig. 1e, Sec. IV-A).

    ``theta`` is matricized with the first ``n_row_modes`` modes as rows;
    blocks are grouped by the fused row charge and each charge sector is
    assembled and SVD'd on the blocks' device.  All singular values then
    reach the host in ONE sync, where truncation is global across sectors:
    keep at most ``max_bond`` values, dropping those ``<= cutoff * s_max``;
    exact ties are broken by (sector, position), so the bond never exceeds
    ``max_bond``.  ``absorb`` multiplies the kept values into U ("left") or
    V ("right"); any other string leaves both isometric.

    Returns ``(U, V, svals_by_sector, trunc_err)``; the new bond carries one
    sector per retained charge, flowing IN on U and OUT on V, and
    ``trunc_err`` is the sum of squared discarded singular values.
    Individual U/V columns are defined up to sign (LAPACK's choice).
    """
    if not theta.blocks:
        raise ValueError("svd_split of a tensor with no blocks")
    row_ix = theta.indices[:n_row_modes]
    col_ix = theta.indices[n_row_modes:]

    groups: Dict[Charge, List[BlockKey]] = {}
    for k in sorted(theta.blocks):
        q = qzero(theta.indices[0].nq)
        for ix, s in zip(row_ix, k[:n_row_modes]):
            q = qadd(q, qscale(ix.charge(s), ix.flow))
        groups.setdefault(q, []).append(k)

    def layout(keys, ixs):
        dims = {k: int(np.prod([ix.sector_dim(s) for ix, s in zip(ixs, k)] or [1])) for k in keys}
        offs, acc = {}, 0
        for k in keys:
            offs[k] = acc
            acc += dims[k]
        return dims, offs, acc

    sectors = []  # (q, U, S, Vh, row_keys, rdim, roff, col_keys, cdim, coff)
    for q, keys in sorted(groups.items()):
        row_keys = sorted({k[:n_row_modes] for k in keys})
        col_keys = sorted({k[n_row_modes:] for k in keys})
        rdim, roff, R = layout(row_keys, row_ix)
        cdim, coff, C = layout(col_keys, col_ix)
        mat = torch.zeros((R, C), dtype=theta.dtype, device=theta.device)
        for k in keys:
            rk, ck = k[:n_row_modes], k[n_row_modes:]
            mat[roff[rk] : roff[rk] + rdim[rk], coff[ck] : coff[ck] + cdim[ck]] = (
                theta.blocks[k].reshape(rdim[rk], cdim[ck])
            )
        U, S, Vh = torch.linalg.svd(mat, full_matrices=False)
        sectors.append((q, U, S, Vh, row_keys, rdim, roff, col_keys, cdim, coff))

    # the one host sync of the split: every sector's singular values at once
    s_all = torch.cat([sec[2] for sec in sectors]).cpu().numpy()
    if not np.isfinite(s_all).all():
        raise NumericalHealthError("non-finite singular values at the truncation sync", stage="svd")
    s_host, off = [], 0
    for sec in sectors:
        n = sec[2].shape[0]
        s_host.append(s_all[off : off + n])
        off += n
    m_q, trunc_err = _truncate(s_host, max_bond, cutoff)

    new_sectors, u_blocks, v_blocks, svals = [], {}, {}, {}
    for m, (q, U, S, Vh, row_keys, rdim, roff, col_keys, cdim, coff) in zip(m_q, sectors):
        m = int(m)
        if m == 0:
            continue
        Uq, Sq, Vq = U[:, :m], S[:m], Vh[:m, :]
        if absorb == "right":
            Vq = Sq[:, None] * Vq
        elif absorb == "left":
            Uq = Uq * Sq[None, :]
        svals[q] = Sq
        new_sectors.append((q, m))
        for rk in row_keys:
            shp = tuple(ix.sector_dim(s) for ix, s in zip(row_ix, rk)) + (m,)
            u_blocks[(q, rk)] = Uq[roff[rk] : roff[rk] + rdim[rk], :].reshape(shp)
        for ck in col_keys:
            shp = (m,) + tuple(ix.sector_dim(s) for ix, s in zip(col_ix, ck))
            v_blocks[(q, ck)] = Vq[:, coff[ck] : coff[ck] + cdim[ck]].reshape(shp)

    # the new bond carries the fused row charge q: IN on U, OUT on V
    bond_u = Index(tuple(new_sectors), IN, "bond")
    bond_v = Index(tuple(new_sectors), OUT, "bond")
    sector_index = {q: i for i, (q, _) in enumerate(new_sectors)}
    U_t = BlockSparseTensor(
        list(row_ix) + [bond_u],
        {rk + (sector_index[q],): b for (q, rk), b in u_blocks.items()},
        qzero(theta.indices[0].nq),
    )
    V_t = BlockSparseTensor(
        [bond_v] + list(col_ix),
        {(sector_index[q],) + ck: b for (q, ck), b in v_blocks.items()},
        theta.charge,
    )
    return U_t, V_t, svals, trunc_err
