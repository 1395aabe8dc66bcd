"""SPMD execution of the bucketed block GEMMs over a ("row", "col") mesh.

The distributed-compute half of the paper: each shape bucket's stacked
block GEMM (``lhs [P, M, K] @ rhs [P, K, N] -> out [O, M, N]``, the pairs
summed into their output slots) is split over the ranks of a 2-D
``torch.distributed`` DeviceMesh, as the reference's shard_map program
splits it (``src/repro/dist/spmd.py``):

- ``P`` (the stacked pair axis) over **"row"**: row rank r owns the pairs
  ``[r*pc, (r+1)*pc)`` of the pair axis zero-padded to a multiple of the row
  size (``pc = ceil(P/rows)``), sums its partial products into all O slots,
  and ONE ``all_reduce`` over the "row" group adds the row shards up;
- ``N`` (the output columns) over **"col"**: col rank c computes the columns
  ``[c*nc, (c+1)*nc)`` of N zero-padded to a multiple of the col size, and
  ONE ``all_gather`` over the "col" group, concatenated along the column
  axis, rejoins them; the padded columns are sliced off.
- ``M``, ``K`` and the output slots ride along whole.

Each rank runs its chunk on the hand-written block GEMM
(``kernels/block_gemm``; on a CUDA tensor it launches the kernel or
raises).  The port pads nothing: the reference's zero-padded pairs point at
slot 0 at the tail of the pair axis, which would break the kernel's
contract that ``out_idx`` is sorted, so a rank takes only the real pairs of
its padded range (``chunk_bounds``; a chunk may be short or empty, and its
slice of the sorted ``oi`` stays sorted).  That is exact: a padded pair
contributes zero.  Output slots that no pair of a chunk reaches come back
as zeros from the kernel as from its plain version, so the all_reduce adds
zeros there.  A short column chunk is computed at its true width and
zero-padded to ``nc`` before the gather, which takes equal sizes.  The
chunk's work list is cached on the bucket's program per output-slot table,
so each (bucket, rank) builds it once.

When the padding would inflate the work past ``PAD_OVERHEAD_LIMIT`` a call
takes the reference's fallback: the whole bucket on every rank, no
collectives, counted in ``stats()["fallback_calls"]``; it too runs on the
block GEMM.

Collectives: with NCCL they run on the card.  Gloo takes the CUDA chunks
as they are and carries them through the host itself (checked on an H100
with torch 2.11 for ``all_reduce``, ``all_gather`` and ``broadcast``); the
GEMMs stay on the card.  No collective is captured into a CUDA graph
(gloo's cannot be), so under an spmd policy the engine runs the matvec and
the environment updates eagerly (``dist/engine.py``).

Equality: the split computes the same sum as the single-process
``block_sparse_matmul`` with the pair products added in another order
(per row shard, then the all_reduce): <=1e-12 on random f64 buckets, and
DMRG energies equal the list backend to <1e-10 at worlds 1, 2 and 4
(``tests/test_torch_spmd.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.block_gemm.ops import block_sparse_matmul, segments
from ..kernels.block_gemm.work import WorkList, shared_work_list
from .plan import EnvironmentPlan

# padding a bucket past this work-inflation factor is slower than computing
# it whole on every rank; such calls take the collective-free fallback
PAD_OVERHEAD_LIMIT = 4.0

_counters = {
    "gemm_calls": 0,
    "fallback_calls": 0,
    "psum_traced": 0,
    "all_gather_traced": 0,
    "all_reduce_calls": 0,
    "all_gather_calls": 0,
}

# one program per (mesh, axes, bucket shape, output slots): its chunk sizes
_PROGRAMS: Dict[Tuple, "SpmdProgram"] = {}


def stats() -> Dict:
    """SPMD counters, cumulative and process-wide (this rank's).

    - ``gemm_calls``: calls of ``spmd_bucket_gemm``;
    - ``fallback_calls``: of those, the ones that took the whole-bucket
      fallback (padding past ``PAD_OVERHEAD_LIMIT``);
    - ``psum_traced`` / ``all_gather_traced``: the reference's names, one
      each per program built, i.e. per unique bucket shape on a mesh;
    - ``all_reduce_calls`` / ``all_gather_calls``: collectives issued (one
      each per non-fallback call: the port runs them eagerly);
    - ``unique_programs``: programs alive.
    """
    return dict(_counters, unique_programs=len(_PROGRAMS))


def reset_stats() -> None:
    for k in _counters:
        _counters[k] = 0


def _ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def chunk_bounds(p: int, n: int, rows: int, cols: int, r: int, c: int):
    """This rank's chunk: ``((lo, hi), (c0, c1), pc, nc)``.

    ``pc = ceil(P/rows)`` and ``nc = ceil(N/cols)`` are the reference's
    padded chunk sizes; ``[lo, hi)`` are the real pairs of row rank r's
    padded range ``[r*pc, (r+1)*pc)`` and ``[c0, c1)`` the real columns of
    col rank c's ``[c*nc, (c+1)*nc)``.
    """
    pc, nc = _ceil_to(p, rows) // rows, _ceil_to(n, cols) // cols
    return (min(r * pc, p), min((r + 1) * pc, p)), (min(c * nc, n), min((c + 1) * nc, n)), pc, nc


def pad_overhead(p: int, n: int, rows: int, cols: int) -> float:
    """The reference's work inflation of padding P and N to the mesh."""
    return (_ceil_to(p, rows) * _ceil_to(n, cols)) / max(p * n, 1)


class SpmdProgram:
    """One bucket shape on one mesh: the axes' groups and sizes, this rank's
    coordinate and chunk sizes (the counterpart of the reference's jitted
    shard_map program)."""

    def __init__(self, mesh, row_axis: str, col_axis: str, p: int, n: int):
        names = mesh.mesh_dim_names
        self.rows, self.cols = mesh.size(names.index(row_axis)), mesh.size(names.index(col_axis))
        coord = mesh.get_coordinate()
        self.r, self.c = coord[names.index(row_axis)], coord[names.index(col_axis)]
        self.row_group, self.col_group = mesh.get_group(row_axis), mesh.get_group(col_axis)
        (self.lo, self.hi), (self.c0, self.c1), _, self.nc = chunk_bounds(p, n, self.rows, self.cols, self.r, self.c)
        self._work: Dict[bytes, WorkList] = {}  # this rank's chunk work list per bucket table
        _counters["psum_traced"] += 1
        _counters["all_gather_traced"] += 1

    def chunk_work(self, oi_loc: np.ndarray, num_out: int, m: int, k: int) -> WorkList:
        """The work list of this rank's chunk of a bucket whose output slots
        are ``oi_loc``, built once per distinct table."""
        key = oi_loc.tobytes()
        wl = self._work.get(key)
        if wl is None:
            wl = self._work[key] = shared_work_list(segments(oi_loc, num_out), m, k, self.c1 - self.c0)
        return wl


def _program(mesh, row_axis, col_axis, p, m, k, n, num_out) -> SpmdProgram:
    key = (mesh, row_axis, col_axis, p, m, k, n, num_out)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = SpmdProgram(mesh, row_axis, col_axis, p, n)
    return prog


def chunk_gemm(lhs: torch.Tensor, rhs: torch.Tensor, oi: np.ndarray, num_out: int, *,
               work: Optional[WorkList] = None, use_kernel: bool = True) -> torch.Tensor:
    """One rank's chunk on the block GEMM: out[o] = sum over the chunk's
    pairs p with oi[p] = o of lhs[p] @ rhs[p], zeros where no pair.
    ``work`` is the chunk's work list (built here when absent)."""
    if work is None:
        work = shared_work_list(segments(oi, num_out), lhs.shape[1], lhs.shape[2], rhs.shape[2])
    return block_sparse_matmul(lhs, rhs, oi, num_out, work=work, use_kernel=use_kernel)


def _all_reduce(t: torch.Tensor, group) -> None:
    _counters["all_reduce_calls"] += 1
    dist.all_reduce(t, group=group)


def _all_gather_cols(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' ``[O, M, nc]`` chunks concatenated along the columns."""
    _counters["all_gather_calls"] += 1
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def spmd_bucket_gemm(lhs: torch.Tensor, rhs: torch.Tensor, oi, num_out: int, *, mesh, row_axis: str = "row",
                     col_axis: str = "col", pad_overhead_limit: float = PAD_OVERHEAD_LIMIT,
                     use_kernel: bool = True) -> torch.Tensor:
    """``out[o] = sum_{p: oi[p]=o} lhs[p] @ rhs[p]``, split over ``mesh``.

    The contract of ``kernels.block_gemm.ops.block_sparse_matmul`` (``oi``
    sorted, a numpy array or a tensor), executed with the pair axis over
    ``row_axis`` and the output columns over ``col_axis``; every rank gets
    the whole result.  See the module docstring.
    """
    p, m, k = lhs.shape
    n = rhs.shape[2]
    oi = np.asarray(oi.cpu() if torch.is_tensor(oi) else oi, dtype=np.int32)
    _counters["gemm_calls"] += 1
    names = mesh.mesh_dim_names
    rows, cols = mesh.size(names.index(row_axis)), mesh.size(names.index(col_axis))
    if pad_overhead(p, n, rows, cols) > pad_overhead_limit:
        _counters["fallback_calls"] += 1
        return chunk_gemm(lhs, rhs, oi, num_out, use_kernel=use_kernel)
    prog = _program(mesh, row_axis, col_axis, p, m, k, n, num_out)
    lo, hi, c0, c1 = prog.lo, prog.hi, prog.c0, prog.c1
    if c1 > c0:
        rhs_loc = rhs[lo:hi] if (c0, c1) == (0, n) else rhs[lo:hi, :, c0:c1].contiguous()
        part = chunk_gemm(lhs[lo:hi], rhs_loc, oi[lo:hi], num_out, work=prog.chunk_work(oi[lo:hi], num_out, m, k),
                          use_kernel=use_kernel)
    else:
        part = lhs.new_zeros((num_out, m, 0))
    if c1 - c0 < prog.nc:
        part = F.pad(part, (0, prog.nc - (c1 - c0)))
    _all_reduce(part, prog.row_group)
    out = _all_gather_cols(part, prog.col_group, prog.cols)
    return out[:, :, :n] if out.shape[2] != n else out


def make_spmd_gemm(mesh, row_axis: str = "row", col_axis: str = "col", *, use_kernel: bool = True):
    """Bind a mesh: a ``gemm_fn(lhs, rhs, oi, num_out)`` for
    ``batch.execute_batched`` / ``batch.execute_batched_blocks``."""

    def gemm_fn(lhs, rhs, oi, num_out):
        return spmd_bucket_gemm(lhs, rhs, oi, num_out, mesh=mesh, row_axis=row_axis, col_axis=col_axis,
                                use_kernel=use_kernel)

    return gemm_fn


def spmd_env_core_body(plan: EnvironmentPlan, gemm_fn):
    """The fused environment update with every contraction on the SPMD
    bucket GEMM ``gemm_fn``: the three chained contractions run through
    ``execute_batched_blocks``, so the environment stage splits over the
    same mesh axes as the matvec.  Runs eagerly (its collectives cannot be
    captured); equal to ``envcore.env_core_body`` up to the order of the
    pair sums (<=1e-12)."""
    from .batch import execute_batched_blocks, matricize_lhs, matricize_rhs

    p1, p2, p3 = plan.steps
    left = plan.side == "left"

    def _step(p, a_blocks, b_blocks):
        if not p.pairs:
            return {}
        a_mats = matricize_lhs(a_blocks, p.keep_a, p.ax_a)
        b_mats = matricize_rhs(b_blocks, p.keep_b, p.ax_b)
        return execute_batched_blocks(p, a_mats, b_mats, gemm_fn=gemm_fn)

    def body(env_blocks, site_blocks, mpo_blocks):
        e = dict(zip(plan.env_keys, env_blocks))
        t = dict(zip(plan.site_keys, site_blocks))
        w = dict(zip(plan.mpo_keys, mpo_blocks))
        bra = {k: torch.conj(v) for k, v in t.items()}
        if left:
            x = _step(p3, bra, _step(p2, _step(p1, e, t), w))
        else:
            x = _step(p3, _step(p2, _step(p1, t, e), w), bra)
        return tuple(x[k].permute(plan.perm) for k in plan.pre_out_keys)

    return body
