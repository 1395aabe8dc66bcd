"""Block placement on the 2-D processor grid: SPMD and storage modes.

The paper distributes *each* quantum-number block over the whole processor
grid instead of assigning whole blocks to nodes: block sizes are very
non-uniform (the largest grows like m), so blocks-to-nodes would load-
imbalance.  ``BlockShardPolicy`` realizes that over a 2-D ("row", "col")
``torch.distributed`` DeviceMesh built by ``make_block_mesh``, in one of two
modes (the reference's, ``src/repro/dist/shard.py``):

- **"spmd"**: every rank keeps every block whole on its own device
  (``place_block`` is a one-time move to the rank's device, a no-op once
  the block is resident), and the heavy compute, each shape bucket's block
  GEMM, is split over the ranks by ``dist/spmd.py``: the pairs over "row",
  the output columns over "col", rejoined by one all_reduce and one
  all_gather per bucket.
- **"storage"**: blocks are *stored* sharded as DTensors.  The largest mode
  divisible by the "row" size is sharded over "row", the largest remaining
  mode divisible by the "col" size over "col", everything else replicated
  (``spec_for``), and every engine operation gathers its operands first
  (``replicated``, one ``full_tensor()`` per block: a collective).
- **"auto"** (default): "storage" on a mesh of CPU devices, "spmd" on the
  card, as the reference chooses.

Placement never changes values: a sweep under either mode equals the
single-process sweep to <1e-10 (``tests/test_torch_spmd.py``).

``host_values`` is the multi-controller agreement of the port (the
reference is single-controller and has none): every rank runs the whole
sweep, so every decision the host takes from device values — Davidson's
break and restart, the kept sectors and bond of each split, whether a
health guard fires and so which ladder rung runs — must be the same on
every rank, or the ranks issue different collectives.  Each such read goes
through ``host_values``, which broadcasts rank 0's values to every rank
over the world group: every rank then decides on rank 0's numbers.  A read
whose local values differ from rank 0's is counted in ``mismatches`` (zero
when the ranks compute bitwise alike, as they do on one device type).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..launch.mesh import local_device, make_mesh
from ..tensor.blocksparse import BlockSparseTensor


def _near_square_factors(n: int) -> Tuple[int, int]:
    r = 1
    for d in range(1, int(n ** 0.5) + 1):
        if n % d == 0:
            r = d
    return r, n // r


def make_block_mesh(shape: Optional[Tuple[int, int]] = None, device=None):
    """2-D ("row", "col") DeviceMesh over all ranks of the world.

    ``device=None`` means the card (raising without one), ``"cpu"`` a mesh of
    CPU ranks.  Without a process group the world is this process alone.
    ``shape`` defaults to the near-square factors of the world size.
    """
    from ..device import resolve_device

    device_type = resolve_device(device).type
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = _near_square_factors(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} ranks")
    return make_mesh(shape, ("row", "col"), device_type)


@dataclasses.dataclass
class BlockShardPolicy:
    """Places blocks on the mesh; ``mode`` picks the execution style
    ("spmd", "storage" or "auto", see the module docstring).

    ``device`` is this rank's device (``launch.mesh.local_device``), the
    one its resident blocks live on.  ``stats()`` reports the agreement
    reads, their broadcasts' mismatches and the storage-mode gathers.
    """

    mesh: object
    row_axis: str = "row"
    col_axis: str = "col"
    mode: str = "auto"

    def __post_init__(self):
        if self.mode not in ("auto", "spmd", "storage"):
            raise ValueError(f"unknown mode {self.mode!r}; one of auto, spmd, storage")
        if self.mode == "auto":
            self.mode = "storage" if self.mesh.device_type == "cpu" else "spmd"
        if self.mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh covers {self.mesh.size()} of {dist.get_world_size()} ranks")
        self.device = local_device(self.mesh.device_type)
        self.host_reads = 0
        self.mismatches = 0
        self.gathers = 0

    @property
    def storage_only(self) -> bool:
        return self.mode == "storage"

    @property
    def rows(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.row_axis))

    @property
    def cols(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.col_axis))

    # ------------------------------------------------------------ placement
    def spec_for(self, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
        """Storage-mode layout: per tensor mode the mesh axis it is sharded
        over, or None.  The largest mode divisible by the row size gets
        "row", the largest remaining one divisible by the col size "col"
        (the reference's rule)."""
        rows, cols = self.rows, self.cols
        assign = [None] * len(shape)
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        row_at = next((i for i in order if rows > 1 and shape[i] % rows == 0), None)
        if row_at is not None:
            assign[row_at] = self.row_axis
        col_at = next((i for i in order if i != row_at and cols > 1 and shape[i] % cols == 0), None)
        if col_at is not None:
            assign[col_at] = self.col_axis
        return tuple(assign)

    def placements_for(self, shape: Tuple[int, ...]):
        """``spec_for`` as DTensor placements, one per mesh dimension."""
        from torch.distributed.tensor import Replicate, Shard

        spec = self.spec_for(tuple(shape))
        return tuple(Shard(spec.index(axis)) if axis in spec else Replicate()
                     for axis in self.mesh.mesh_dim_names)

    def place_block(self, block: torch.Tensor) -> torch.Tensor:
        if self.mode == "spmd":
            return block.to(self.device)  # no copy once resident
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(block, DTensor):
            return block
        # every rank holds the same full block: each keeps its own shard, no
        # collective (src_data_rank=None)
        return distribute_tensor(block.to(self.device), self.mesh, self.placements_for(block.shape),
                                 src_data_rank=None)

    def place(self, t: BlockSparseTensor) -> BlockSparseTensor:
        """Every block of ``t`` placed per the policy (values unchanged)."""
        return BlockSparseTensor(t.indices, {k: self.place_block(b) for k, b in t.blocks.items()}, t.charge)

    def place_mps(self, tensors):
        return [self.place(t) for t in tensors]

    def _replicated_block(self, block: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        if isinstance(block, DTensor):
            self.gathers += 1
            return block.full_tensor()
        return block

    def replicated(self, t: BlockSparseTensor) -> BlockSparseTensor:
        """Every block gathered whole on this rank: the storage mode's
        gather-before-compute; a no-op on spmd-mode blocks."""
        if t is None:
            return t
        return BlockSparseTensor(t.indices, {k: self._replicated_block(b) for k, b in t.blocks.items()}, t.charge)

    # ------------------------------------------------------------ agreement
    def host_values(self, t: torch.Tensor) -> np.ndarray:
        """``t`` read on the host, rank 0's values on every rank."""
        self.host_reads += 1
        local = t.detach()
        if dist.get_world_size() == 1:
            return local.cpu().numpy()
        flat = torch.view_as_real(local) if local.is_complex() else local
        buf = flat.contiguous().clone()
        dist.broadcast(buf, src=0)
        if not torch.equal(buf, flat):
            self.mismatches += 1
        out = buf.cpu()
        return (torch.view_as_complex(out) if local.is_complex() else out).numpy()

    def stats(self):
        return {"mode": self.mode, "mesh": (self.rows, self.cols), "backend": dist.get_backend(),
                "host_reads": self.host_reads, "mismatches": self.mismatches, "gathers": self.gathers}
