"""The port's slice end to end on the Heisenberg chain (8 sites, m=16, no
truncation), held against the JAX package and exact diagonalization.

A file of its own so that its JAX reference run (the slowest part of the
port's tests) goes to another test worker than the 3x2 run of
``test_torch_dmrg.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import models as jmodels  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402

from _torch_helpers import check_slice, jax_reference  # noqa: E402

N, BONDS = 8, (16,)


@pytest.fixture(scope="module")
def ref():
    return jax_reference(*jmodels.heisenberg_chain_system(N), N, BONDS)


@pytest.mark.parametrize("algo", ["csr", "list", "list_unplanned"])
def test_slice_matches_jax_and_ed(ref, algo):
    """Energies <1e-10 from the JAX run and <=1e-7 from ED."""
    check_slice(ref, *tmodels.heisenberg_chain_system(N), N, BONDS, algo, ed_tol=1e-7)
