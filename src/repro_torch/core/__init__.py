"""DMRG core on the block-sparse substrate."""
from .checkpoint import CheckpointManager, pack_run_state, tensor_restore, tensor_state
from .davidson import DavidsonInfo, davidson
from .dmrg import DMRGResult, run_dmrg
from .ed import build_dense_hamiltonian, ground_energy
from .env import expectation, get_contractor, matvec_two_site
from .models import heisenberg_chain_system, spin_system
from .mpo import build_mpo, compress_mpo, mpo_bond_dims
from .measure import correlation, correlation_profile, site_expectation
from .mps import MPS, neel_states, product_state_mps, right_canonicalize, total_charge
from .siteops import electron_space, spin_half_space
from .sweep import DMRGEngine, SweepStats

__all__ = [
    "CheckpointManager", "pack_run_state", "tensor_restore", "tensor_state",
    "correlation", "correlation_profile", "site_expectation", "right_canonicalize",
    "DavidsonInfo", "davidson", "DMRGResult", "run_dmrg",
    "build_dense_hamiltonian", "ground_energy", "expectation",
    "get_contractor", "matvec_two_site", "heisenberg_chain_system",
    "spin_system", "build_mpo", "compress_mpo", "mpo_bond_dims", "MPS",
    "neel_states", "product_state_mps", "total_charge", "electron_space",
    "spin_half_space", "DMRGEngine", "SweepStats",
]
