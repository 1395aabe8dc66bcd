"""Model registry and problem building for the serving subsystem.

A *problem* is (model name, n_sites, Hamiltonian parameters) plus solver
settings; ``build_problem`` turns a ``ProblemSpec`` into the (space, MPO)
pair the solver consumes, and ``group_key`` derives the batching identity:
two problems batch together iff they share the model, size and solver
settings AND the MPO block structure (``mpo_structure_signature``), because
only then is the whole sweep identical up to block values.

Parameter values deliberately do NOT enter the group key: a J-sweep with 64
values forms one group and rides one set of captured graphs.  Even
degenerate values batch (h=0 keeps the field channel with zero blocks after
compression, structure unchanged); anything that does change the block
structure -- a different model, lattice, or sector layout -- is caught by
the signature part of the key and lands in a separate group.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..core.models import heisenberg_chain_terms, heisenberg_j1j2_terms
from ..core.mpo import build_mpo, compress_mpo
from ..core.siteops import spin_half_space
from .multicore import mpo_structure_signature

# model name -> builder(n_sites, **params) -> (space, terms).  Parameters not
# passed fall back to the builder defaults, so a spec only names the swept
# ones.
MODEL_BUILDERS: Dict[str, Callable] = {
    # nearest-neighbor Heisenberg chain, params J (coupling) and h (field)
    "heisenberg": lambda n, J=1.0, h=0.0: (spin_half_space(), heisenberg_chain_terms(n, j=J, h=h)),
    # J1-J2 ladder (Ly=2 strip of the paper's 2D model), params J1 and J2
    "j1j2_ladder": lambda n, J1=1.0, J2=0.5: (
        spin_half_space(),
        heisenberg_j1j2_terms(n // 2, 2, J1, J2, cylinder=False),
    ),
}


def build_problem(spec) -> Tuple:
    """(space, compressed MPO) for a ProblemSpec, on the CPU.

    Pure host work (MPO assembly and compression on CPU tensors), so it is
    safe on a submitting thread while the worker captures CUDA graphs; the
    solver moves the MPO to the card on the worker thread.
    """
    builder = MODEL_BUILDERS.get(spec.model)
    if builder is None:
        raise ValueError(f"unknown model {spec.model!r}; registered: {sorted(MODEL_BUILDERS)}")
    space, terms = builder(spec.n_sites, **dict(spec.params))
    mpo = build_mpo(space, terms, spec.n_sites, device="cpu")
    return space, compress_mpo(mpo, cutoff=spec.mpo_cutoff)


def group_key(spec, mpo) -> Tuple:
    """Batch-group identity: solver settings + MPO block structure."""
    return (
        spec.model,
        spec.n_sites,
        spec.max_bond,
        spec.sweeps_per_bond,
        spec.davidson_iters,
        spec.cutoff,
        mpo_structure_signature(mpo),
    )
