"""What the "auto" cost model chooses on the 8x4 cylinder, and why.

    python scripts/auto_choices.py [--device cpu] [--bonds 128,256,512,1024,1024]

Runs ``DMRGEngine(algo="auto", jit_matvec=True)`` on ``chip_smoke.py``'s
8x4 J1-J2 cylinder (f64, ``davidson_iters=2``, one sweep per bond) and
prints per sweep the contractions by backend.  Then it sweeps once more at
the last bond with a fresh plan cache and prints, per contraction kind
(output rank 4 or 5), the median of the cost model's two dispatch terms:
the block pairs that "list" pays a GEMM dispatch for, and the batched
backend's charge 0.5 x unique blocks + 2 x buckets + 0.25 x output slots
(``ContractionEngine.choose_backend``; both pay the same flops).  The
choice depends on the block structure alone, so the CPU shows what the
card runs; on a card the sweep seconds are the card's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bonds", default="128,256,512,1024,1024")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import spin_system
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.core.mps import neel_states, product_state_mps
    from repro_torch.core.sweep import DMRGEngine
    from repro_torch.device import resolve_device
    from repro_torch.dist.plan import PlanCache

    dev = resolve_device(args.device)
    bonds = [int(b) for b in args.bonds.split(",")]
    space, terms = spin_system(8, 4)
    mpo = compress_mpo(build_mpo(space, terms, 32, device=dev), cutoff=1e-13)
    eng = DMRGEngine(product_state_mps(space, neel_states(space, 32), device=dev), mpo, algo="auto",
                     jit_matvec=True, davidson_iters=2, device=dev)
    for m in bonds:
        t0 = time.perf_counter()
        st = eng.sweep(max_bond=m)
        print(json.dumps(dict(m=m, max_bond=st.max_bond, energy=st.energy, seconds=time.perf_counter() - t0,
                              backend_counts=st.backend_counts)), flush=True)

    engine = eng.contract_fn
    terms_by_rank = defaultdict(list)
    choose = engine.choose_backend

    def spy(plan):
        if plan.num_pairs:
            L = plan.batched
            charge = 0.5 * L.num_unique + 2.0 * L.num_buckets + 0.25 * L.num_out_slots
            terms_by_rank[len(plan.out_indices)].append((plan.num_pairs, charge, L.num_buckets))
        return choose(plan)

    engine.choose_backend = spy
    engine.cache = PlanCache()  # every plan of the sweep is priced again
    eng.sweep(max_bond=bonds[-1])
    for rank, rows in sorted(terms_by_rank.items()):
        a = np.array(rows)
        print(json.dumps(dict(output_rank=rank, plans=len(a), median_pairs=float(np.median(a[:, 0])),
                              median_batched_charge=float(np.median(a[:, 1])),
                              median_buckets=float(np.median(a[:, 2])),
                              share_batched_cheaper=float(np.mean(a[:, 1] < a[:, 0])))))


if __name__ == "__main__":
    main()
