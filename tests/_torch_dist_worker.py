"""Rank bodies of the port's distributed CPU tests (``test_torch_spmd.py``).

Spawned by ``torch.multiprocessing`` (the spawn method): a module of its own
so that a rank imports only torch and the port, never JAX.  Each rank joins
a gloo world through a ``FileStore``, runs its cases, and writes what it saw
to ``<out_dir>/<rank>.json``.
"""
from __future__ import annotations

import collections
import json
import os

import numpy as np


def dmrg_case(rank: int, world: int, store_file: str, out_dir: str, shape, mpo_arrays, bonds, run_kw) -> None:
    """One rank: ``run_dmrg`` on the 3x2 open J1-J2 lattice (J2=0.5) with
    the given MPO, under an spmd-mode and then a storage-mode policy on a
    mesh of ``shape``, then split bucket GEMMs on random buckets whose pair
    and column counts do not divide the mesh, against the plain GEMM."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import mpo_from_arrays
    from repro_torch.core import run_dmrg
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.siteops import spin_half_space
    from repro_torch.dist import spmd
    from repro_torch.dist.shard import BlockShardPolicy, make_block_mesh
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref
    from repro_torch.launch.mesh import init_world

    torch.set_num_threads(1)  # tiny GEMMs; the ranks share the cores with other tests
    init_world("cpu", store=dist.FileStore(store_file, world), rank=rank, world_size=world)
    try:
        mesh = make_block_mesh(tuple(shape), device="cpu")
        space, terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
        calls = collections.Counter()
        inner = spmd.spmd_bucket_gemm

        def counted(lhs, rhs, oi, num_out, **kw):
            calls[(lhs.shape[0], rhs.shape[2])] += 1
            return inner(lhs, rhs, oi, num_out, **kw)

        out = {}
        for mode in ("spmd", "storage"):
            policy = BlockShardPolicy(mesh, mode=mode)
            spmd.reset_stats()
            calls.clear()
            spmd.spmd_bucket_gemm = counted
            try:
                res = run_dmrg(space, terms, 6, bond_schedule=tuple(bonds), shard_policy=policy, spmd=mode == "spmd",
                               algo="batched", mpo=mpo_from_arrays(mpo_arrays, device="cpu"), device="cpu", **run_kw)
            finally:
                spmd.spmd_bucket_gemm = inner
            out[mode] = {"energies": res.energies, "spmd": spmd.stats(), "policy": policy.stats(),
                         "calls": [[p, n, c] for (p, n), c in sorted(calls.items())]}
        rng = np.random.default_rng(0)
        policy = BlockShardPolicy(mesh, mode="spmd")
        out["gemm"] = []
        for p, n in ((3, 5), (1, 1), (2, 4), (5, 7), (0, 3)):
            m = k = 4
            o = max(1, p // 2)
            lhs = torch.from_numpy(rng.standard_normal((p, m, k)))
            rhs = torch.from_numpy(rng.standard_normal((p, k, n)))
            oi = np.sort(rng.integers(0, o, size=p)).astype(np.int32)
            got = spmd.spmd_bucket_gemm(lhs, rhs, oi, o, mesh=policy.mesh, pad_overhead_limit=1e9)
            want = block_sparse_matmul_ref(lhs, rhs, oi, o)
            out["gemm"].append(float((got - want).abs().max()) if got.numel() else 0.0)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
