"""One rank of a distributed DMRG run: ``run_dmrg(spmd=True)`` on the J1-J2
cylinder, each rank writing what it saw to ``OUT/<rank>.json``.

Run it under ``torchrun`` (every rank runs the whole sweep; the bucket GEMMs
are split over the ranks), for example two ranks sharing one card over
gloo on a 1x2 mesh::

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/spmd_dmrg.py --backend gloo --mesh 1x2 --bonds 16,64 --out chiprun_out/spmd_2

and one rank with NCCL (``--backend nccl --mesh 1x1``).  NCCL refuses two
ranks on one card, so on one card only a world of one can take it.
``--device cpu`` runs the ranks on the CPU (gloo).

Per rank the record holds the per-sweep energies and seconds, the SPMD
ledger (``dist.spmd.stats``), the policy's agreement reads and mismatches,
every ladder counter, and the block GEMM launches by variant counted from
just before ``run_dmrg`` to just after it.  With ``--probe`` (on the card)
the largest chunk this rank ran on the block GEMM is run again after the
run, outside the counts: held against the plain version and timed beside
it, beside ``bmm`` + ``index_add_`` on the same chunk and beside its bound.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: f64 (tensor cores) and HBM rates, 700 W
PEAK_F64_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe_chunk(chunk) -> dict:
    """The largest chunk again: kernel vs plain version (max abs error),
    each timed, with the library call and the bound."""
    from repro_torch.dist.spmd import chunk_gemm
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref

    lhs, rhs, oi, num_out = chunk
    got = chunk_gemm(lhs, rhs, oi, num_out)
    want = block_sparse_matmul_ref(lhs, rhs, oi, num_out)
    idx = torch.as_tensor(oi, device=lhs.device).long()

    def library():
        out = torch.zeros((num_out, lhs.shape[1], rhs.shape[2]), dtype=lhs.dtype, device=lhs.device)
        return out.index_add_(0, idx, torch.bmm(lhs, rhs))

    p, m, k = lhs.shape
    n = rhs.shape[2]
    ops = 2.0 * p * m * k * n
    nbytes = 8.0 * (lhs.numel() + rhs.numel() + num_out * m * n)
    t_ops, t_bytes = ops / PEAK_F64_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(shape=[p, m, k, n, num_out], max_abs_err=(got - want).abs().max().item(),
                rel_err=(got - want).abs().max().item() / max(want.abs().max().item(), 1e-300),
                ms=time_ms(lambda: chunk_gemm(lhs, rhs, oi, num_out)),
                plain_ms=time_ms(lambda: block_sparse_matmul_ref(lhs, rhs, oi, num_out)),
                library_ms=time_ms(library), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--mesh", default="1x1", help="ROWSxCOLS of the ranks")
    ap.add_argument("--lx", type=int, default=8)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--j2", type=float, default=0.5)
    ap.add_argument("--bonds", default="16,64", help="bond schedule, comma separated")
    ap.add_argument("--sweeps-per-bond", type=int, default=1)
    ap.add_argument("--davidson-iters", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--probe", action="store_true", help="time the largest chunk after the run (card only)")
    ap.add_argument("--out", required=True, help="directory of the per-rank records")
    args = ap.parse_args()

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.dist import spmd
    from repro_torch.dist.shard import BlockShardPolicy, make_block_mesh
    from repro_torch.launch.mesh import init_world

    if args.device == "cuda" and not torch.cuda.is_available():
        print("spmd_dmrg: no CUDA device is available", file=sys.stderr)
        return 1
    init_world(args.device, backend="gloo" if args.device == "cpu" else args.backend)
    rank = dist.get_rank()
    shape = tuple(int(s) for s in args.mesh.split("x"))
    policy = BlockShardPolicy(make_block_mesh(shape, device=args.device), mode="spmd")
    dev = policy.device
    n = args.lx * args.ly
    space, terms = spin_system(args.lx, args.ly, args.j2)
    mpo = compress_mpo(build_mpo(space, terms, n, device=dev), cutoff=1e-13)
    bonds = tuple(int(b) for b in args.bonds.split(","))

    largest = {}
    if args.probe:
        inner = spmd.chunk_gemm

        def recorded(lhs, rhs, oi, num_out, **kw):
            work = lhs.shape[0] * lhs.shape[1] * lhs.shape[2] * rhs.shape[2]
            if work > largest.get("work", -1):
                largest.update(work=work, chunk=(lhs, rhs, oi.copy(), num_out))
            return inner(lhs, rhs, oi, num_out, **kw)

        spmd.chunk_gemm = recorded
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    spmd.reset_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, n, bond_schedule=bonds, sweeps_per_bond=args.sweeps_per_bond,
                   davidson_iters=args.davidson_iters, mpo=mpo, algo="batched", shard_policy=policy, spmd=True,
                   device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.VARIANT_LAUNCHES["block_gemm"])
    st = res.engine_stats
    rec = dict(
        rank=rank, world=dist.get_world_size(), backend=dist.get_backend(), mesh=list(shape), device=str(dev),
        bonds=bonds, wall_s=wall, energies=res.energies, seconds=[s.seconds for s in res.sweep_stats],
        max_bonds=[s.max_bond for s in res.sweep_stats], spmd=spmd.stats(), policy=policy.stats(),
        block_gemm_launches=launches, backend_counts=st["backend_counts"],
        graph_captures=st["graphs"]["graph_captures"],
        ladder=dict(retries=st["retries"], degradations=st["degradations"], svd_retries=st["decomp"]["retries"],
                    svd_degradations=st["decomp"]["degradations"],
                    pair_retries=[s.pair_retries for s in res.sweep_stats]),
    )
    if args.probe:
        spmd.chunk_gemm = inner
        if largest and dev.type == "cuda":
            rec["largest_chunk"] = probe_chunk(largest["chunk"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{rank}.json"), "w") as f:
        json.dump(rec, f)
    print(f"rank {rank}: E={res.energy:.12f} in {wall:.1f} s, block_gemm {launches}, spmd {spmd.stats()}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
