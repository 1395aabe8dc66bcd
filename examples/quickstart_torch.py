"""Quickstart of the PyTorch port: a DMRG ground-state solve validated
against exact diagonalization, the paper's algorithm end to end on the
block-sparse substrate (the counterpart of ``examples/quickstart.py``).

    python examples/quickstart_torch.py                 # on the CUDA card
    python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.core import run_dmrg
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.siteops import spin_half_space

    # 3x2 J1-J2 Heisenberg patch (the paper's "spins" system, small)
    space = spin_half_space()
    terms = heisenberg_j1j2_terms(3, 2, j1=1.0, j2=0.5, cylinder=False)
    n_sites = 6

    print("running two-site DMRG (list algorithm) ...")
    result = run_dmrg(
        space, terms, n_sites,
        bond_schedule=(8, 16), sweeps_per_bond=2, davidson_iters=6,
        verbose=True, device=args.device,
    )
    e_exact = ground_energy(space, terms, n_sites, charge=(0,))
    print(f"\nDMRG energy : {result.energy:.12f}")
    print(f"ED energy   : {e_exact:.12f}")
    print(f"|error|     : {abs(result.energy - e_exact):.2e}")
    assert abs(result.energy - e_exact) < 1e-8
    print("OK — DMRG matches exact diagonalization.")
    return result.energy, e_exact


if __name__ == "__main__":
    main()
