"""The electron system's MPO in the port against the JAX package: the
open 3x2 triangular Hubbard patch (d=4, the Jordan-Wigner strings of the
hoppings) contracted to a dense matrix against the JAX package's ED
Hamiltonian, and the compressed bond dimension at width 6, the paper's
k=26 for this system (``core/mpo.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import models as jmodels  # noqa: E402
from repro.core.ed import build_dense_hamiltonian  # noqa: E402
from repro.core.mpo import build_mpo as jax_build_mpo, compress_mpo as jax_compress_mpo  # noqa: E402
from repro.core.mpo import mpo_bond_dims as jax_mpo_bond_dims  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.core.ed import build_dense_hamiltonian as port_dense_hamiltonian  # noqa: E402
from repro_torch.core.mpo import build_mpo, compress_mpo, mpo_bond_dims  # noqa: E402

from _torch_helpers import mpo_to_dense  # noqa: E402


def patch_3x2(pkg):
    return pkg.electron_space(), pkg.triangular_hubbard_terms(3, 2, 1.0, 8.5, cylinder=False)


@pytest.fixture(scope="module")
def hamiltonian():
    return build_dense_hamiltonian(*patch_3x2(jmodels), 6)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_mpo_contracts_to_the_ed_hamiltonian(hamiltonian, pkg):
    """Each package's compressed MPO of the 3x2 patch, contracted to a dense
    4096 x 4096 matrix, equals the JAX package's ED Hamiltonian to 1e-12."""
    if pkg == "port":
        mpo = compress_mpo(build_mpo(*patch_3x2(tmodels), 6, device="cpu"), cutoff=1e-13)
        dense = [w.to_dense().numpy() for w in mpo]
    else:
        mpo = jax_compress_mpo(jax_build_mpo(*patch_3x2(jmodels), 6), cutoff=1e-13)
        dense = [np.asarray(w.to_dense()) for w in mpo]
    np.testing.assert_allclose(mpo_to_dense(dense), hamiltonian, rtol=0, atol=1e-12)


def test_ed_hamiltonian_matches_jax(hamiltonian):
    """The port's dense Hamiltonian of the 3x2 patch (the ED that the card's
    exact checks use) equals the JAX package's to 1e-12."""
    np.testing.assert_allclose(port_dense_hamiltonian(*patch_3x2(tmodels), 6), hamiltonian, rtol=0, atol=1e-12)


def test_compressed_bond_dims_at_width_6():
    """At width 6 (``electron_system(3, 6)``, 18 sites: the shortest
    cylinder whose middle bonds reach the width's full k) both packages
    compress the MPO (cutoff 1e-13) to the same bond dimensions, the largest
    26, the paper's k for the electron system."""
    dims = mpo_bond_dims(compress_mpo(build_mpo(*tmodels.electron_system(3, 6), 18, device="cpu"), cutoff=1e-13))
    jax_dims = jax_mpo_bond_dims(jax_compress_mpo(jax_build_mpo(*jmodels.electron_system(3, 6), 18), cutoff=1e-13))
    assert list(dims) == list(jax_dims)
    assert max(dims) == 26
