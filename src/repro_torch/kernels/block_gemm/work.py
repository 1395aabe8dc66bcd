"""Host planner of the block GEMM kernel: routes, work items and the second
pass's tables, from a layout's segments and per-pair extents.

The kernel (``block_gemm.cu``) computes out[o] = sum_p lhs[p] @ rhs[p] over
output tiles of TM x TN, numbered (o * MT + m-tile) * NT + n-tile over the
padded [O, BM, BN] output.  Output block o covers the tiles that its
pairs' largest rows and columns reach; each of them has the same work, its
*units*: (pair, k-tile) in pair order over the pairs of the segment that
have depth.  (In a csr layout every pair of a block has the block's rows
and columns; a pair that is smaller reads as zeros beyond its extents.)
The planner cuts each block's units into work items of about equal size,
one set per tile, so that one long segment does not hold the launch back:

- a tile whose units fit one item is written by that item (dest = -1);
- a tile cut into n >= 2 items gets n consecutive workspace slots, one per
  item, and a ``fix`` row (first slot, n) that the second pass sums in
  slot order;
- a tile that no pair reaches is written as zeros by the second pass.

``tile_fix`` tells the second pass, per tile, which of the three it is.
Nothing here depends on the numbers in the operands, so a layout builds its
work list once and reuses it (``dist/plan.py``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

# route -> (TM, TN, TK, fewest units an item is cut to)
ROUTES = {"tiled": (64, 64, 16, 16), "skinny": (256, 16, 16, 8)}
SKINNY_MAX = 16  # BK and BN at most this take the skinny route
# Items a launch aims at: about eight per SM of an H100 (132 SMs), so that
# a tile longer than the mean share of the card is cut.
TARGET_ITEMS = 132 * 8
ITEM_FIELDS = 5  # tile, first pair, first k-tile, units, dest
WRITTEN, ZEROS = -1, -2  # tile_fix of a tile that its item writes, of a tile no pair reaches


def route(bm: int, bk: int, bn: int) -> str:
    """The kernel route of a (BM, BK, BN) launch: ``skinny`` when BK and BN
    are both at most 16 (the MPO steps of the matvec), else ``tiled``."""
    return "skinny" if bk <= SKINNY_MAX and bn <= SKINNY_MAX else "tiled"


def variant(route_name: str, dtype: torch.dtype) -> str:
    """The kernel a launch runs: ``skinny``, ``tiled_dmma`` (f64 on the FP64
    tensor cores) or ``tiled_fma`` (f32 and bf16 on the CUDA cores)."""
    if route_name == "skinny":
        return "skinny"
    return "tiled_dmma" if dtype == torch.float64 else "tiled_fma"


@dataclasses.dataclass
class WorkList:
    """Work items and second-pass tables of one (segments, extents, shape)."""

    route: str
    tm: int
    tn: int
    tk: int
    shape: tuple                 # (P, O, BM, BK, BN) the list was built for
    items: np.ndarray            # [n_items, 5] int32, longest first
    fix: np.ndarray              # [n_cut, 2] int32 (first slot, count) per tile that was cut
    tile_fix: np.ndarray         # [n_tiles] int32: WRITTEN, ZEROS, or its fix row
    n_slots: int
    _dev: Dict = dataclasses.field(default_factory=dict, repr=False)

    def __getstate__(self):
        # the device tables belong to the process that uploaded them
        return {**self.__dict__, "_dev": {}}

    def tables(self, device: torch.device):
        """(items, fix, tile_fix) on ``device``, uploaded once per device
        without a host sync (the sources are this list's own arrays)."""
        t = self._dev.get(device)
        if t is None:
            t = tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in (self.items, self.fix, self.tile_fix))
            self._dev[device] = t
        return t


_SHARED: "OrderedDict[tuple, WorkList]" = OrderedDict()
SHARED_MAX = 4096


def shared_work_list(seg, bm: int, bk: int, bn: int) -> WorkList:
    """``work_list(seg, None, bm, bk, bn)``, one object per distinct
    (segments, shape) in the process (LRU, ``SHARED_MAX`` lists): the
    batched backend meets the same small bucket shapes at every bond, and a
    shared list uploads its tables once per device."""
    seg = np.asarray(seg, dtype=np.int32)
    key = (seg.tobytes(), int(bm), int(bk), int(bn))
    wl = _SHARED.get(key)
    if wl is None:
        wl = _SHARED[key] = work_list(seg, None, bm, bk, bn)
        while len(_SHARED) > SHARED_MAX:
            _SHARED.popitem(last=False)
    else:
        _SHARED.move_to_end(key)
    return wl


def work_list(seg, extents: Optional[np.ndarray], bm: int, bk: int, bn: int) -> WorkList:
    """The work list of pairs ``seg`` [O+1] (pairs of output o are
    seg[o]:seg[o+1]) with true per-pair (rows, depth, cols) ``extents``
    [P, 3] (None: every pair spans BM x BK x BN)."""
    seg = np.asarray(seg, dtype=np.int64)
    n_out, n_pairs = len(seg) - 1, int(seg[-1])
    name = route(bm, bk, bn)
    tm, tn, tk, min_units = ROUTES[name]
    if extents is None:
        ext = np.tile(np.array([bm, bk, bn], np.int64), (n_pairs, 1))
    else:
        ext = np.asarray(extents, dtype=np.int64).reshape(-1, 3)
        if len(ext) != n_pairs or (ext < 0).any() or (ext > [bm, bk, bn]).any():
            raise ValueError(f"extents must be [P={n_pairs}, 3] within (BM, BK, BN) = {(bm, bk, bn)}")
    mt_all, nt_all = -(-bm // tm), -(-bn // tn)

    # per output block: its units, the tiles it covers, and its cut into
    # n items of near-equal size
    nkt = -(-ext[:, 1] // tk)
    unit_start = np.concatenate([[0], np.cumsum(nkt)])  # of each pair, in units
    units = unit_start[seg[1:]] - unit_start[seg[:-1]]
    has = units > 0
    # largest rows and columns per block (a zero row ends the table, so that
    # every segment start indexes it; empty blocks read it and have no units)
    padded = np.concatenate([ext, np.zeros((1, 3), np.int64)])
    reach = np.stack([np.maximum.reduceat(padded[:, i], seg[:-1]) for i in (0, 2)], 1)
    mts, nts = np.where(has, -(-reach[:, 0] // tm), 0), np.where(has, -(-reach[:, 1] // tn), 0)
    n_tiles = mts * nts
    chunk = max(min_units, -(-int((units * n_tiles).sum()) // TARGET_ITEMS))
    n_cut = -(-units // chunk)
    # the cuts of every block: [lo, hi) of its units, starting at (pair, k-tile)
    o_cut = np.repeat(np.arange(n_out), n_cut)
    i_cut = np.arange(len(o_cut)) - np.repeat(np.cumsum(n_cut) - n_cut, n_cut)
    lo = i_cut * units[o_cut] // n_cut[o_cut]
    hi = (i_cut + 1) * units[o_cut] // n_cut[o_cut]
    g_lo = unit_start[seg[o_cut]] + lo
    p_lo = np.searchsorted(unit_start, g_lo, side="right") - 1
    # items: every cut of a block, on every tile it covers
    per_o = n_tiles * n_cut
    o_item = np.repeat(np.arange(n_out), per_o)
    k_item = np.arange(len(o_item)) - np.repeat(np.cumsum(per_o) - per_o, per_o)  # tile-major within o
    t_local, c_local = k_item // n_cut[o_item], k_item % n_cut[o_item]
    cut_idx = np.repeat(np.cumsum(n_cut) - n_cut, per_o) + c_local
    tile = (o_item * mt_all + t_local // nts[o_item]) * nt_all + t_local % nts[o_item]
    is_cut = n_cut[o_item] >= 2
    slots = np.where(n_cut >= 2, per_o, 0)
    dest = np.where(is_cut, np.repeat(np.cumsum(slots) - slots, per_o) + k_item, -1)
    items = np.stack([tile, p_lo[cut_idx], (g_lo - unit_start[p_lo])[cut_idx], (hi - lo)[cut_idx], dest], 1)
    items = items[np.argsort(-items[:, 3], kind="stable")]  # longest first

    tile_fix = np.full(n_out * mt_all * nt_all, ZEROS, np.int32)
    tile_fix[tile] = WRITTEN
    first_items = tile[is_cut & (c_local == 0)]
    tile_fix[first_items] = np.arange(len(first_items))
    fix = np.stack([dest[is_cut & (c_local == 0)], n_cut[o_item][is_cut & (c_local == 0)]], 1)
    return WorkList(
        route=name, tm=tm, tn=tn, tk=tk, shape=(n_pairs, n_out, bm, bk, bn),
        items=items.astype(np.int32).reshape(-1, ITEM_FIELDS),
        fix=fix.astype(np.int32).reshape(-1, 2), tile_fix=tile_fix, n_slots=int(slots.sum()),
    )
