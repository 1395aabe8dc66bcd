"""The port's slice end to end on the 3x2 open J1-J2 system (6 sites, m=8,
no truncation), its MPO, and its Davidson, held against the JAX package.

The JAX reference run (``algo="list"``, seed SVD, three-call environment
updates) is computed once per module; the Heisenberg chain instance lives in
``test_torch_dmrg_chain.py`` so that the two reference runs go to different
test workers.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import env as jenv  # noqa: E402
from repro.core import models as jmodels  # noqa: E402
from repro.core.davidson import davidson as jax_davidson  # noqa: E402
from repro.core.ed import build_dense_hamiltonian  # noqa: E402
from repro.tensor import blocksparse as jbs  # noqa: E402
from repro_torch.convert import bst_from_arrays, mpo_from_arrays, mps_from_arrays  # noqa: E402
from repro_torch.core import env as tenv  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.core.davidson import davidson  # noqa: E402
from repro_torch.core.mpo import build_mpo, compress_mpo, mpo_bond_dims  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402
from repro_torch.tensor import blocksparse as tbs  # noqa: E402

from _torch_helpers import check_slice, jax_from_arrays, jax_reference, mpo_to_dense, to_arrays  # noqa: E402

N, BONDS = 6, (8,)


def j1j2_3x2(pkg):
    return pkg.spin_half_space(), pkg.heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)


@pytest.fixture(scope="module")
def ref():
    return jax_reference(*j1j2_3x2(jmodels), N, BONDS)


@pytest.mark.parametrize("algo", ["csr", "list", "list_unplanned"])
def test_slice_matches_jax_and_ed(ref, algo):
    """Energies <1e-10 from the JAX run and <=1e-8 from ED."""
    check_slice(ref, *j1j2_3x2(tmodels), N, BONDS, algo, ed_tol=1e-8)


@pytest.mark.parametrize("system", ["j1j2_3x2", "chain_8"])
def test_mpo_contracts_to_the_ed_hamiltonian(system):
    """The port's compressed MPO, contracted to a dense matrix, equals the
    JAX package's ED Hamiltonian to 1e-12, with the JAX MPO's bond dims.
    (Block by block the two MPOs differ by the SVD sign gauge.)"""
    from repro.core.mpo import build_mpo as jax_build_mpo, compress_mpo as jax_compress_mpo
    from repro.core.mpo import mpo_bond_dims as jax_mpo_bond_dims

    if system == "j1j2_3x2":
        (jsp, jterms), (tsp, tterms), n = j1j2_3x2(jmodels), j1j2_3x2(tmodels), N
    else:
        n = 8
        (jsp, jterms), (tsp, tterms) = jmodels.heisenberg_chain_system(n), tmodels.heisenberg_chain_system(n)
    mpo = compress_mpo(build_mpo(tsp, tterms, n, device="cpu"), cutoff=1e-13)
    jmpo = jax_compress_mpo(jax_build_mpo(jsp, jterms, n), cutoff=1e-13)
    assert mpo_bond_dims(mpo) == jax_mpo_bond_dims(jmpo)
    H = build_dense_hamiltonian(jsp, jterms, n)
    np.testing.assert_allclose(mpo_to_dense([w.to_dense().numpy() for w in mpo]), H, rtol=0, atol=1e-12)
    carried = mpo_from_arrays([to_arrays(w) for w in jmpo], device="cpu")
    np.testing.assert_allclose(mpo_to_dense([w.to_dense().numpy() for w in carried]), H, rtol=0, atol=1e-12)


def _middle_operator(T, W, pkg_env, contract_fn):
    """Environments of the middle pair (j, j+1) of a chain of tensors."""
    n, j = len(T), len(T) // 2 - 1
    A = pkg_env.left_edge(T[0], W[0])
    for i in range(j):
        A = pkg_env.extend_left(A, T[i], W[i], contract_fn)
    B = pkg_env.right_edge(T[n - 1], W[n - 1])
    for i in range(n - 2, j, -1):
        B = pkg_env.extend_right(B, T[i + 1], W[i + 1], contract_fn)
    return j, A, B


def test_davidson_on_carried_operator(ref):
    """The JAX run's MPS and MPO carried across: Davidson on the middle
    pair's two-site operator, from the same perturbed start, gives the same
    eigenvalue in both packages to 1e-10 (the port's matvec on the csr
    engine), with no restart on either side."""
    jT = [jax_from_arrays(a) for a in ref["mps"]]
    jW = [jax_from_arrays(a) for a in ref["mpo"]]
    tT = mps_from_arrays(ref["mps"], device="cpu").tensors
    tW = mpo_from_arrays(ref["mpo"], device="cpu")
    j, jA, jB = _middle_operator(jT, jW, jenv, jbs.contract)
    _, tA, tB = _middle_operator(tT, tW, tenv, tbs.contract)

    theta = to_arrays(jbs.contract(jT[j], jT[j + 1], ((2,), (0,))))
    rng = np.random.default_rng(0)
    noisy = (theta[0], theta[1], {k: b + 0.1 * rng.standard_normal(b.shape) for k, b in theta[2].items()})
    lam_j, _, info_j = jax_davidson(
        lambda x: jenv.matvec_two_site(jA, jW[j], jW[j + 1], jB, x, jbs.contract),
        jax_from_arrays(noisy), n_iter=4,
    )
    lam_t, x_t, info_t = davidson(
        ContractionEngine("csr").matvec_fn(tA, tW[j], tW[j + 1], tB),
        bst_from_arrays(*noisy, device="cpu"), n_iter=4,
    )
    assert abs(lam_t - lam_j) <= 1e-10
    assert info_t.restarts == info_j.restarts == 0
    assert abs(float(x_t.norm()) - 1.0) <= 1e-12


def test_davidson_restart_branch():
    """A Gram-Schmidt breakdown restarts from a seeded random direction.
    The two packages draw different directions, so this is held to the
    exact eigenvalue only: on A = 2*Id (tol=0 forbids the converged break)
    every Ritz value is exactly 2."""
    arrays = ([((((0,), 3), ((1,), 2)), 1, "a"), ((((0,), 4),), -1, "b")], (0,),
              {(0, 0): np.random.default_rng(1).standard_normal((3, 4))})
    lam_t, _, info_t = davidson(lambda x: x.scale(2.0), bst_from_arrays(*arrays, device="cpu"), n_iter=3, tol=0.0)
    lam_j, _, info_j = jax_davidson(lambda x: x.scale(2.0), jax_from_arrays(arrays), n_iter=3, tol=0.0)
    assert info_t.restarts >= 1 and info_j.restarts >= 1 and not info_t.exhausted
    assert abs(lam_t - 2.0) <= 1e-12 and abs(lam_j - 2.0) <= 1e-12
