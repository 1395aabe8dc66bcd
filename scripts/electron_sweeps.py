"""The paper's electron system sweep by sweep, on one contraction path.

    python scripts/electron_sweeps.py --algo csr [--lx 4] [--ly 6] [--bonds 64,256,1024] [--out FILE]
    python scripts/electron_sweeps.py --algo batched --device cpu --lx 2 --bonds 16,32

Runs ``run_dmrg`` on the triangular Hubbard cylinder (``electron_system(lx,
ly)``: t=1, U=8.5, d=4, charges (N, 2Sz); f64, ``davidson_iters=2``, one
sweep per bond, from ``neel_states``) through one path: ``csr`` (the
per-sector SVD and three-call environment updates, as ``chip_smoke.py``
phase 4 runs it), ``batched`` (``jit_matvec=True``: the planned pipeline
with its CUDA graphs) or ``auto`` (``jit_matvec=True``: the cost model per
contraction).  Prints one JSON line per sweep: its seconds, energy, bond,
SVD and environment seconds, the host planner's work lists and their
milliseconds, contractions by backend and the shape buckets of the batched
ones (captures and eager calls), graph captures, replays, evictions, pool
and static-buffer bytes, block GEMM launches by variant (replays included)
and the card's peak memory; then the run's: wall time, launches, the csr
operands' packed bytes (summed; the largest pack), SVD calls, sectors,
buckets and host syncs.  With ``--out`` the record is also written there as
JSON.  ``chip_smoke.py`` phase 22 runs its paths through ``run_path``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PATHS = {
    "csr": dict(algo="csr", svd_method="unplanned", jit_env=False),
    "batched": dict(algo="batched", jit_matvec=True),
    "auto": dict(algo="auto", jit_matvec=True),
}


def sweep_rows(res, bonds) -> list:
    """One row per sweep of a run with one sweep per bond (see above)."""
    rows = []
    for m, st in zip(bonds, res.sweep_stats):
        g = st.graphs
        rows.append(dict(m=m, energy=st.energy, seconds=st.seconds, max_bond=st.max_bond, trunc_err=st.trunc_err,
                         svd_seconds=st.svd_seconds, env_seconds=st.env_seconds, work_lists=st.work_lists,
                         work_list_ms=st.work_list_ms, backend_counts=st.backend_counts, buckets=st.buckets,
                         graph_captures=g["graph_captures"], graph_replays=g["graph_replays"],
                         graph_evictions=g["evictions"], capture_seconds=g["capture_seconds"],
                         instantiate_seconds=g["instantiate_seconds"], pool_bytes=g["pool_bytes"],
                         buffer_bytes=g["buffer_bytes"], block_gemm_launches=st.block_gemm_launches,
                         peak_gib=st.peak_bytes / 2**30, davidson_restarts=st.davidson_restarts,
                         davidson_exhausted=st.davidson_exhausted))
    return rows


def run_path(space, terms, mpo, algo: str, bonds, dev, davidson_iters: int = 2):
    """One run through the path ``algo`` of PATHS: its record (see above)
    and its ``DMRGResult``."""
    from repro_torch import kernels
    from repro_torch.core import run_dmrg

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, len(mpo), bond_schedule=bonds, sweeps_per_bond=1, davidson_iters=davidson_iters,
                   mpo=mpo, device=dev, **PATHS[algo])
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    variants = dict(kernels.VARIANT_LAUNCHES["block_gemm"])
    sweeps = sweep_rows(res, bonds)
    st, dec = res.engine_stats, res.engine_stats["decomp"]
    rec = dict(algo=algo, bonds=tuple(bonds), wall_s=wall, sweeps=sweeps, energies=res.energies,
               variant_launches=variants, launches=sum(variants.values()),
               backend_counts={k: sum(r["backend_counts"][k] for r in sweeps) for k in sweeps[0]["backend_counts"]},
               buckets=sum(r["buckets"] for r in sweeps),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None, csr_packed=st["csr_packed"],
               svd_calls=dec["svd_calls"], svd_sectors=dec["sectors"], svd_buckets=dec["buckets"],
               svd_host_syncs=dec["host_syncs"], retries=st["retries"], degradations=st["degradations"])
    return rec, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=sorted(PATHS), required=True)
    ap.add_argument("--lx", type=int, default=4)
    ap.add_argument("--ly", type=int, default=6)
    ap.add_argument("--bonds", default="64,256,1024")
    ap.add_argument("--davidson-iters", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="JSON record of the run")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("electron_sweeps: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core.models import electron_system
    from repro_torch.core.mpo import build_mpo, compress_mpo, mpo_bond_dims

    dev = torch.device(args.device)
    head = dict(lx=args.lx, ly=args.ly, device=str(dev), torch=torch.__version__)
    if dev.type == "cuda":
        head["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(head["nvidia_smi"], flush=True)
    n = args.lx * args.ly
    space, terms = electron_system(args.lx, args.ly)
    t0 = time.perf_counter()
    mpo = compress_mpo(build_mpo(space, terms, n, device=dev), cutoff=1e-13)
    head.update(mpo_bond_dims=mpo_bond_dims(mpo), mpo_s=time.perf_counter() - t0)
    print(json.dumps(dict(sites=n, mpo_k=max(head["mpo_bond_dims"]), mpo_s=head["mpo_s"])), flush=True)
    rec, _ = run_path(space, terms, mpo, args.algo, tuple(int(b) for b in args.bonds.split(",")), dev,
                      args.davidson_iters)
    for row in rec["sweeps"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({k: v for k, v in rec.items() if k != "sweeps"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**head, **rec}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
