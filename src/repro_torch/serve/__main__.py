"""CLI front end: ``python -m repro_torch.serve`` -- batched parameter sweeps.

Expands ``--sweep NAME=a:b:n`` ranges into a cartesian grid of problems,
submits them all through a ``DMRGService`` queue, and prints one row per
problem plus the service stats.  ``--check`` re-solves every problem alone
with ``run_dmrg(algo="batched", jit_matvec=True)`` and asserts the batched
energies match to 1e-10, that the warmed pipeline served the whole sweep
with zero retraces (graph captures), and that no recovery ran.

Example (the README quickstart, on the CUDA card)::

    PYTHONPATH=src python -m repro_torch.serve --model heisenberg --n-sites 8 \\
        --max-bond 16 --sweep J=0.8:1.2:4 --sweep h=0.2:0.4:2 --batch 4 --check

``--device cpu`` runs it on the CPU.  ``--plan-store DIR`` activates the
persistent plan store (``dist/persist.py``) for the whole process: plans are
loaded from it and written back, and the warmup replays the structures it
records.  ``--warmup MODEL[,m=BOND][,n=SITES]`` (repeatable) is the
warmup-only mode: it primes ``--plan-store`` with the named model's whole
bond schedule at every slot size and exits; a later process on that store
builds no plan and captures nothing that the warmup captured.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np


def parse_sweep(arg: str) -> Tuple[str, np.ndarray]:
    """``NAME=a:b:n`` -> (name, linspace(a, b, n)); ``NAME=v`` -> single value."""
    try:
        name, rng = arg.split("=", 1)
        parts = rng.split(":")
        if len(parts) == 1:
            return name, np.array([float(parts[0])])
        lo, hi, n = float(parts[0]), float(parts[1]), int(parts[2])
        if n < 1:
            raise ValueError
        return name, np.linspace(lo, hi, n)
    except ValueError:
        raise SystemExit(f"bad --sweep {arg!r}: expected NAME=a:b:n or NAME=value")


def build_grid(sweeps: List[Tuple[str, np.ndarray]]) -> List[Dict[str, float]]:
    """Cartesian product of the swept axes as per-problem parameter dicts."""
    if not sweeps:
        return [{}]
    names = [s[0] for s in sweeps]
    return [{n: float(v) for n, v in zip(names, combo)} for combo in itertools.product(*(s[1] for s in sweeps))]


def parse_warmup(arg: str, default_m: int, default_n: int):
    """``MODEL[,m=BOND][,n=SITES]`` -> (model, max_bond, n_sites)."""
    parts = arg.split(",")
    model, m, n = parts[0], default_m, default_n
    try:
        for p in parts[1:]:
            k, v = p.split("=", 1)
            if k == "m":
                m = int(v)
            elif k == "n":
                n = int(v)
            else:
                raise ValueError
        if not model:
            raise ValueError
    except ValueError:
        raise SystemExit(f"bad --warmup {arg!r}: expected MODEL[,m=BOND][,n=SITES]")
    return model, m, n


def run_warmup(args) -> int:
    """Warmup-only mode: prime the plan store for each --warmup target.

    For every ``MODEL,m=...`` target this runs the service warmup (one full
    solve per power-of-two slot size, covering every bond-schedule
    structure) against the activated ``--plan-store``, whose plans and
    structure records it writes back.
    """
    from . import DMRGService, ProblemSpec

    if not args.plan_store:
        print("--warmup requires --plan-store (nowhere to persist)", file=sys.stderr)
        return 2
    targets = [parse_warmup(t, args.max_bond, args.n_sites) for t in args.warmup]
    svc = DMRGService(max_batch=args.batch, start=False, plan_store=args.plan_store, device=args.device)
    sizes = [s for s in (1, 2, 4, 8, 16, 32, 64) if s <= args.batch]
    try:
        for model, m, n in targets:
            spec = ProblemSpec.make(model, n, max_bond=m, sweeps_per_bond=args.sweeps_per_bond,
                                    davidson_iters=args.davidson_iters)
            t0 = time.perf_counter()
            svc.warmup(spec, sizes=sizes)
            print(f"warmed {model} (m={m}, n={n}) x sizes {sizes} in {time.perf_counter() - t0:.1f}s "
                  f"({svc.store_warmups[-1].get('captures', 0)} captures replayed from the store, "
                  f"{svc.ops.retraces} in all)")
    finally:
        svc.shutdown()
    st = svc.plan_store.stats()
    print(f"plan store {st['root']}: {st['saves']} plan saves, {st['hits']} plan hits, "
          f"{st['structure_saves']} structure records added")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Batched DMRG parameter sweeps through the serving queue.",
    )
    ap.add_argument("--model", default="heisenberg", help="registered model name (see repro_torch.serve.MODEL_BUILDERS)")
    ap.add_argument("--n-sites", type=int, default=8)
    ap.add_argument("--max-bond", type=int, default=16)
    ap.add_argument("--sweeps-per-bond", type=int, default=2)
    ap.add_argument("--davidson-iters", type=int, default=6)
    ap.add_argument("--sweep", action="append", default=[], metavar="NAME=a:b:n",
                    help="parameter range (repeat for a cartesian grid)")
    ap.add_argument("--batch", type=int, default=8, help="max batch slot size (padded to powers of two)")
    ap.add_argument("--queue", type=int, default=64, help="admission bound (backpressure threshold)")
    ap.add_argument("--no-warmup", action="store_true", help="skip the warmup solves (first batches capture)")
    ap.add_argument("--plan-store", metavar="DIR",
                    help="persistent plan store, activated for the whole process, primed by warmup")
    ap.add_argument("--warmup", action="append", default=[], metavar="MODEL[,m=BOND][,n=SITES]",
                    help="warmup-only mode: prime --plan-store with the named model's bond schedule at every "
                         "slot size, then exit (repeatable)")
    ap.add_argument("--stats-json", metavar="PATH", help="write service + plan-cache stats as JSON ('-' = stdout)")
    ap.add_argument("--checkpoint-dir", metavar="DIR",
                    help="journal undelivered requests here; a restarted service with the same dir re-enqueues them")
    ap.add_argument("--check", action="store_true",
                    help="verify vs per-problem solves, zero retraces, and a zero recovery ledger")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.warmup:
        return run_warmup(args)

    from ..core import run_dmrg
    from ..tensor.blocksparse import BlockSparseTensor
    from . import DEVICE_LOCK, DMRGService, ProblemSpec, group_key
    from .problems import build_problem

    grid = build_grid([parse_sweep(s) for s in args.sweep])
    specs = [
        ProblemSpec.make(args.model, args.n_sites, max_bond=args.max_bond, sweeps_per_bond=args.sweeps_per_bond,
                         davidson_iters=args.davidson_iters, **params)
        for params in grid
    ]

    svc = DMRGService(max_batch=args.batch, max_queue=args.queue, checkpoint_dir=args.checkpoint_dir,
                      plan_store=args.plan_store, device=args.device)
    try:
        if not args.no_warmup:
            sizes = [s for s in (1, 2, 4, 8, 16, 32, 64) if s <= args.batch]
            t0 = time.perf_counter()
            # warm one spec per distinct group (structure-changing parameters
            # like h=0 vs h!=0 land in different groups)
            seen = set()
            for spec in specs:
                key = group_key(spec, build_problem(spec)[1])
                if key in seen:
                    continue
                seen.add(key)
                svc.warmup(spec, sizes=sizes)
            print(f"warmup: {len(seen)} group(s) x sizes {sizes} in {time.perf_counter() - t0:.1f}s "
                  f"({svc.ops.retraces} captures)")
            if svc.plan_store is not None:
                st = svc.plan_store.stats()
                print(f"plan store: {svc.ops.engine.stats()['plan_builds']} plan builds, {st['hits']} plan hits, "
                      f"{sum(w.get('captures', 0) for w in svc.store_warmups)} captures replayed from "
                      f"{st['structure_loads']} structure records")

        rids = [svc.submit(spec, timeout=60.0) for spec in specs]
        print(f"submitted {len(rids)} problems (batch<={args.batch}, queue<={args.queue})")

        results = []
        for rid, spec in zip(rids, specs):
            rec = svc.result(rid, timeout=3600.0)
            results.append(rec)
            label = " ".join(f"{k}={v:g}" for k, v in spec.params)
            print(f"  [{rid:3d}] {label:30s} E = {rec['energy']:+.12f}  "
                  f"(bond {rec['max_bond']}, batch {rec['batch_size']})")

        stats = svc.stats()
        print(f"served {stats['completed']} problems on {stats['device']} in {stats['solve_seconds']:.2f}s solve "
              f"time: {stats['problems_per_sec']:.2f} problems/sec, fill {stats['batch_fill_ratio']:.2f}, "
              f"retraces {stats['retraces']}")
        if args.stats_json:
            payload = json.dumps(stats, indent=2, default=str)
            if args.stats_json == "-":
                print(payload)
            else:
                with open(args.stats_json, "w") as fh:
                    fh.write(payload + "\n")
                print(f"stats written to {args.stats_json}")

        if args.check:
            worst, single_ladders = 0.0, []
            for spec, rec in zip(specs, results):
                space, mpo = build_problem(spec)
                mpo = [BlockSparseTensor(w.indices, {k: b.to(svc.device) for k, b in w.blocks.items()}, w.charge)
                       for w in mpo]
                with DEVICE_LOCK:  # never work on the card beside the worker
                    ref = run_dmrg(space, None, spec.n_sites, bond_schedule=spec.bond_schedule,
                                   sweeps_per_bond=spec.sweeps_per_bond, davidson_iters=spec.davidson_iters,
                                   cutoff=spec.cutoff, mpo=mpo, algo="batched", jit_matvec=True,
                                   device=svc.device)
                worst = max(worst, abs(rec["energy"] - ref.energy))
                st = ref.engine_stats
                single_ladders.append(bool(st["retries"] or st["degradations"] or st["decomp"]["retries"]
                                           or any(st["decomp"]["degradations"].values())
                                           or any(s.pair_retries for s in ref.sweep_stats)))
            print(f"check: max |E_batched - E_single| = {worst:.3e}")
            if not worst < 1e-10:
                print("CHECK FAILED: batched energies diverge", file=sys.stderr)
                return 1
            if not args.no_warmup and stats["retraces"] != 0:
                print(f"CHECK FAILED: {stats['retraces']} steady-state retraces", file=sys.stderr)
                return 1
            # with no faults armed, a clean sweep must never touch the
            # recovery machinery
            if not stats["faults"]["armed"]:
                ledger = {k: stats[k] for k in ("retries", "bisections", "worker_restarts", "unrecovered_errors")}
                ladders = stats["ladders"]
                if (any(ledger.values()) or ladders["retries"] or ladders["degradations"] or ladders["svd_retries"]
                        or any(ladders["svd_degradations"].values()) or any(single_ladders)):
                    print(f"CHECK FAILED: nonzero recovery ledger {ledger}, ladders {ladders}, "
                          f"single runs {single_ladders}", file=sys.stderr)
                    return 1
            print("CHECK OK")
        return 0
    finally:
        svc.shutdown()


if __name__ == "__main__":
    sys.exit(main())
