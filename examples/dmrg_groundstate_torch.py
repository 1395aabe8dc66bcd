"""End-to-end entry point of the PyTorch port for the paper's own workload: DMRG
ground-state search on the two benchmark systems (spins: 2D J1-J2
Heisenberg; electrons: triangular Hubbard), with a growing bond-dimension
schedule, per-sweep energy/truncation logging, and a choice of the
contraction algorithms.  The counterpart of ``examples/dmrg_groundstate.py``,
flag for flag, plus ``--device`` (default: the CUDA card; without one it
raises rather than running on the CPU).

    python examples/dmrg_groundstate_torch.py --system electrons --lx 3 \
        --ly 2 --max-bond 64 --algo csr --check-ed
    python examples/dmrg_groundstate_torch.py --system spins --lx 3 --ly 2 \
        --device cpu --check-ed

``--shard`` and ``--spmd`` run under a ``dist.shard.BlockShardPolicy`` over
the ``torch.distributed`` world (``launch/mesh.py``): a world of one in a
plain process, every rank of the world under ``torchrun``.  ``--shard``
takes the policy's "auto" mode ("storage" on CPU ranks, "spmd" on the
card), ``--spmd`` its "spmd" mode, as the reference's flags do.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

ALGOS = ["list", "dense", "csr", "csr_ref", "batched", "auto", "list_unplanned"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--system", choices=["spins", "electrons"], default="spins")
    ap.add_argument("--lx", type=int, default=4)
    ap.add_argument("--ly", type=int, default=2)
    ap.add_argument("--max-bond", type=int, default=32)
    ap.add_argument("--sweeps-per-bond", type=int, default=2)
    ap.add_argument("--algo", choices=ALGOS, default="list")
    ap.add_argument("--jit-matvec", action="store_true",
                    help="run the padded two-site matvec and environment "
                         "updates as CUDA graphs per padded structure")
    ap.add_argument("--no-jit-env", action="store_true",
                    help="disable the fused environment updates (engine "
                         "algos default to them; bare algos always use the "
                         "seed extend path)")
    ap.add_argument("--svd-method",
                    choices=["svd", "randomized", "auto", "unplanned"],
                    default=None,
                    help="decomposition stage: planned batched SVD (default "
                         "for engine algos), randomized sketch, cost-model "
                         "auto, or the seed per-sector loop")
    ap.add_argument("--shard", action="store_true",
                    help="place blocks under a BlockShardPolicy over the "
                         "torch.distributed world (storage mode on CPU "
                         "ranks, spmd on the card)")
    ap.add_argument("--spmd", action="store_true",
                    help="SPMD execution: every bucket GEMM split over the "
                         "(row, col) mesh of the world's ranks; implies the "
                         "padded matvec")
    ap.add_argument("--j2", type=float, default=0.5)
    ap.add_argument("--u", type=float, default=8.5)
    ap.add_argument("--check-ed", action="store_true",
                    help="compare against exact diagonalization (small only)")
    ap.add_argument("--stats-json", metavar="PATH",
                    help="write run stats + the run's plan-cache counters as "
                         "JSON ('-' = stdout)")
    ap.add_argument("--checkpoint-dir", metavar="DIR",
                    help="persist sweep checkpoints here and resume from "
                         "the newest one on restart")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="site updates between mid-sweep checkpoints "
                         "(sweep boundaries always checkpoint)")
    ap.add_argument("--plan-store", metavar="DIR",
                    help="persistent plan store: a primed store builds no "
                         "plan and captures every graph before the first "
                         "sweep; a cold run primes it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.algo.endswith("_unplanned") and (
        args.shard or args.spmd or args.jit_matvec
    ):
        ap.error("--shard/--spmd/--jit-matvec require an engine algo, "
                 "not " + args.algo)
    if args.shard and args.spmd:
        ap.error("--shard (storage mode) and --spmd are mutually exclusive")
    if args.algo.endswith("_unplanned") and args.svd_method not in (
        None, "unplanned",
    ):
        ap.error("--svd-method " + args.svd_method
                 + " requires an engine algo, not " + args.algo)

    from repro_torch.core import run_dmrg
    from repro_torch.core.models import electron_system, spin_system
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.system == "spins":
        space, terms = spin_system(args.lx, args.ly, j2=args.j2)
    else:
        space, terms = electron_system(args.lx, args.ly, u=args.u)
    n = args.lx * args.ly

    shard_policy = None
    if args.shard or args.spmd:
        from repro_torch.dist.shard import BlockShardPolicy, make_block_mesh
        shard_policy = BlockShardPolicy(
            make_block_mesh(device=device), mode="spmd" if args.spmd else "auto"
        )

    schedule = [m for m in (8, 16, 32, 64, 128, 256) if m <= args.max_bond]
    mesh = ""
    if shard_policy is not None:
        mesh = f", mesh={dict(zip(shard_policy.mesh.mesh_dim_names, shard_policy.mesh.shape))}"
    print(f"{args.system}: {args.lx}x{args.ly} cylinder, {n} sites, "
          f"algo={'spmd' if args.spmd else args.algo}, schedule={schedule}" + mesh)
    res = run_dmrg(space, terms, n, bond_schedule=schedule,
                   sweeps_per_bond=args.sweeps_per_bond,
                   davidson_iters=4, algo=args.algo, verbose=True,
                   jit_matvec=args.jit_matvec or args.spmd,
                   shard_policy=shard_policy, spmd=args.spmd,
                   svd_method=args.svd_method,
                   jit_env=False if args.no_jit_env
                   or args.algo.endswith("_unplanned") else None,
                   checkpoint_dir=args.checkpoint_dir,
                   checkpoint_every=args.checkpoint_every,
                   plan_store=args.plan_store, device=device)
    print(f"\nground-state energy estimate: {res.energy:.10f}")
    print(f"energy per site:              {res.energy / n:.10f}")

    if args.check_ed and n <= 12:
        from repro_torch.core.ed import ground_energy
        from repro_torch.core.mps import neel_states, total_charge
        q = total_charge(space, neel_states(space, n))
        e0 = ground_energy(space, terms, n, charge=q)
        print(f"ED reference:                 {e0:.10f} "
              f"(|err|={abs(res.energy - e0):.2e})")

    if args.stats_json:
        import json

        payload = {
            "energy": float(res.energy),
            "energy_per_site": float(res.energy) / n,
            "n_sites": n,
            "algo": args.algo,
            "schedule": schedule,
            "caches": cache_payload(res.engine_stats),
        }
        if args.spmd:
            from repro_torch.dist import spmd_stats

            payload["spmd"] = spmd_stats()
        text = json.dumps(payload, indent=2, default=str)
        if args.stats_json == "-":
            print(text)
        else:
            with open(args.stats_json, "w") as fh:
                fh.write(text + "\n")
            print(f"stats written to {args.stats_json}")
    return res


def cache_payload(stats: dict) -> dict:
    """The payload's ``caches``: the keys of the reference's
    ``repro.dist.cache_stats`` (every counter zero without an engine), read
    from the run's engine stats, with those stats under ``engines``."""
    from repro_torch.dist import cache_stats

    out = cache_stats()
    if stats:
        out.update(plan_cache=stats["plan_cache"], decomp_plan_cache=stats["decomp"]["plan_cache"],
                   env_plan_cache=stats["env"]["plan_cache"], engines=[stats])
    return out


if __name__ == "__main__":
    main()
