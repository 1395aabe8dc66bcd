"""One process of the cold-start check: ``run_dmrg(plan_store=DIR)`` on the
J1-J2 cylinder, printing what the run built and captured.

Run it twice on one store: the first process (cold) builds every plan and
captures every graph, and writes both to the store; the second (primed)
loads every plan (0 builds) and captures the stored structures in its
warmup, before the first sweep, so that its sweeps capture nothing::

    PYTHONPATH=src python scripts/plan_store_run.py --store /tmp/store   # cold
    PYTHONPATH=src python scripts/plan_store_run.py --store /tmp/store   # primed

The last line of the output is ``PLAN_STORE_RUN {json}``: the per-sweep
energies, seconds and graph captures, the plan builds, the warmup's records,
captures and seconds, the block GEMM launches by variant, and the store's
counters.  ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True, help="plan store directory")
    ap.add_argument("--lx", type=int, default=8)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--bonds", default="128,256", help="bond schedule, comma separated (one sweep each)")
    ap.add_argument("--algo", default="auto")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    from repro_torch import kernels
    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.device import resolve_device
    from repro_torch.dist import PlanStore

    dev = resolve_device(args.device)
    n = args.lx * args.ly
    space, terms = spin_system(args.lx, args.ly)
    mpo = compress_mpo(build_mpo(space, terms, n, device=dev), cutoff=1e-13)
    store = PlanStore(args.store)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, n, bond_schedule=tuple(int(b) for b in args.bonds.split(",")), sweeps_per_bond=1,
                   davidson_iters=2, mpo=mpo, algo=args.algo, jit_matvec=True, plan_store=store, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    st = res.engine_stats
    out = dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", wall_s=time.perf_counter() - t0,
        energies=res.energies, seconds=[s.seconds for s in res.sweep_stats],
        sweep_captures=[s.graphs["graph_captures"] for s in res.sweep_stats], plan_builds=st["plan_builds"],
        warmup=res.warmup, block_gemm_launches=dict(kernels.VARIANT_LAUNCHES["block_gemm"]),
        ladder=dict(retries=st["retries"], degradations=st["degradations"], svd_retries=st["decomp"]["retries"],
                    pair_retries=[s.pair_retries for s in res.sweep_stats]),
        store=store.stats(),
    )
    print("PLAN_STORE_RUN " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
