"""Process groups and device meshes for the distributed DMRG path.

The reference builds a ``jax.sharding.Mesh`` over the devices of one
controller.  The port is multi-controller: every rank is a process that
runs the whole sweep, and a ``torch.distributed`` DeviceMesh names the
ranks' grid.  Two helpers:

- ``init_world`` starts the default process group of this process: from
  the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT``) when it is set, from an explicit
  ``store``/``rank``/``world_size`` (the tests' ``FileStore``), and
  otherwise as a world of one rank on an in-memory store, which is how a
  plain process runs ``run_dmrg(spmd=True)``.  Every group gets a finite
  ``timeout`` (``DIST_TIMEOUT`` by default), so ranks that issue different
  collectives fail with an error instead of waiting forever.
- ``make_mesh(shape, axes, device_type)`` is ``init_device_mesh`` over the
  world; the groups it creates along each mesh dimension take the same
  finite timeout.

``make_production_mesh`` gives the reference's production meshes, (16, 16)
over ("data", "model") or (2, 16, 16) over ("pod", "data", "model"), for
the dry run (``launch/dryrun.py``): one process stands for every rank, in
a fake process group (``fake_world``) whose collectives move nothing.
``HW`` holds the roofline constants of the NVIDIA H100 SXM5 80GB.

Ranks that share one card cannot take NCCL, which refuses two ranks on
one card: ``backend_for`` gives them gloo, which carries CUDA tensors
through the host.  Mesh training's collectives there are DTensor's
functional all_gather_into_tensor, reduce_scatter_tensor, all_reduce and
all_to_all_single on CUDA tensors.  On the H100 with torch 2.11
(``scripts/gloo_cuda_probe.py``): all of them, and c10d's calls of the same
names, run right in a gloo world of 2, except the functional
all_gather_into_tensor, which kills the process (SIGSEGV) while c10d's
``all_gather_into_tensor`` of the same tensors runs right.  The runner of
such worlds (``scripts/mesh_runs.py``) routes those gathers through c10d
while its runs last; this package leaves torch's collectives as they are.

``mesh_context`` is the reference's entry point for a mesh scope.  A
DeviceMesh is not entered: its collectives name their groups explicitly,
so the context does nothing and exists so that callers read alike.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it raises
DIST_TIMEOUT = 120.0


def backend_for(device_type: str) -> str:
    """The default backend of a device type: gloo on the CPU; on the card
    NCCL, or gloo where this host's ranks (torchrun's ``LOCAL_WORLD_SIZE``)
    outnumber its cards and so share one."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) <= torch.cuda.device_count() else "gloo"


def init_world(
    device_type: str = "cuda",
    *,
    backend: Optional[str] = None,
    store=None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout: float = DIST_TIMEOUT,
) -> None:
    """Initialize the default process group unless one exists.

    ``backend`` defaults to ``backend_for(device_type)``.  Without a
    ``store`` and without the ``torchrun`` environment the world is this
    process alone.
    """
    if dist.is_initialized():
        return
    backend = backend or backend_for(device_type)
    td = datetime.timedelta(seconds=timeout)
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, timeout=td)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=td)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=td)


def local_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` (ranks may
    share one card) or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


@contextlib.contextmanager
def _default_group_timeout(timeout: datetime.timedelta):
    """Make ``timeout`` the default of groups created inside: DeviceMesh
    creates its per-dimension groups with the library default (30 minutes),
    and a hang should fail within the world's own timeout."""
    c10d = dist.distributed_c10d
    saved = {k: getattr(c10d, k) for k in ("default_pg_timeout", "default_pg_nccl_timeout") if hasattr(c10d, k)}
    for k in saved:
        setattr(c10d, k, timeout)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(c10d, k, v)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda",
              timeout: float = DIST_TIMEOUT):
    """A DeviceMesh of ``shape`` named ``axes`` over the world's ranks.

    Starts a world of one rank first when no process group exists.  On the
    card each rank's device is set to ``local_device`` before the mesh is
    made, so several ranks can share one card.
    """
    from torch.distributed.device_mesh import init_device_mesh

    init_world(device_type, timeout=timeout)
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    with _default_group_timeout(datetime.timedelta(seconds=timeout)):
        return init_device_mesh(device_type, tuple(int(s) for s in shape), mesh_dim_names=tuple(axes))


def mesh_context(mesh):
    """The reference's mesh scope; a DeviceMesh needs none (see the module
    docstring)."""
    return contextlib.nullcontext(mesh)


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of ``world_size``
    ranks (``torch.testing``'s fake backend: every collective returns at
    once and moves nothing), unless a process group exists."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists; the mesh needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def fake_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cpu"):
    """A DeviceMesh of ``shape`` over a fake world of its size (see
    ``fake_world``); the dry run's meshes are CPU meshes of fake tensors."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(int(np.prod(shape)))
    return init_device_mesh(device_type, tuple(int(s) for s in shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes)


# NVIDIA H100 SXM5 80GB at 700 W, per GPU: spec-sheet figures, not
# measurements, for the dry run's roofline
HW = dict(
    peak_flops_bf16=989.4e12,  # FLOP/s, dense bf16 on the tensor cores (spec sheet)
    hbm_bw=3.35e12,            # B/s, HBM3 (spec sheet)
    hbm_bytes=80e9,            # bytes of HBM3 (spec sheet)
    nvlink_bw=450e9,           # B/s per direction, NVLink 4, inside a node (spec sheet)
    node_gpus=8,               # GPUs a node holds, all to all over NVLink
    internode_bw=50e9,         # B/s per GPU between nodes: one 400 Gb/s link (spec sheet)
)

