"""The planned pipeline's CUDA graphs sweep by sweep.

    python scripts/sweep_graphs.py [--bonds 128,256,512,1024,1024,1024,1024,1024]

Runs ``run_dmrg(algo="batched", jit_matvec=True)`` on ``chip_smoke.py``'s
8x4 J1-J2 cylinder (f64, ``davidson_iters=2``, one sweep per bond) after a
warm-up run at small bonds (kernel build, cuSOLVER handles).  Prints per
sweep its seconds, SVD and environment seconds, the graph cache's
captures (new padded structures), replays and capture seconds, and the
energy, then the run's wall time and peak memory.  The default bonds add
two sweeps at m=1024 to chip_smoke's six, to show whether structures recur
once the bond stops growing.  Needs a CUDA card.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bonds", default="128,256,512,1024,1024,1024,1024,1024")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.mpo import build_mpo, compress_mpo

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    space, terms = spin_system(8, 4)
    mpo = compress_mpo(build_mpo(space, terms, 32, device=dev), cutoff=1e-13)
    kw = dict(sweeps_per_bond=1, davidson_iters=2, algo="batched", jit_matvec=True, mpo=mpo, device=dev)
    run_dmrg(space, terms, 32, bond_schedule=(16, 32), **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bonds = tuple(int(b) for b in args.bonds.split(","))
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, 32, bond_schedule=bonds, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for m, s in zip(bonds, res.sweep_stats):
        g = s.graphs
        print(json.dumps(dict(m=m, seconds=s.seconds, svd_seconds=s.svd_seconds, env_seconds=s.env_seconds,
                              captures=g["graph_captures"], replays=g["graph_replays"],
                              capture_seconds=g["capture_seconds"], energy=s.energy)))
    print(json.dumps(dict(bonds=bonds, wall_s=wall,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)))


if __name__ == "__main__":
    main()
