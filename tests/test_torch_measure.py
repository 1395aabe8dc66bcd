"""The port's observables (``core/measure.py``) against exact
diagonalization and against the reference's measurements of the same MPS.

Mirrors ``tests/test_measure.py``: the reference's DMRG ground state of the
3x2 open J1-J2 system, from its own test's run, is carried across as
arrays, so both packages measure the same state; they agree to 1e-12, and
with ED to 1e-8.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import measure as jmeasure  # noqa: E402
from repro.core import models as jmodels  # noqa: E402
from repro.core.ed import build_dense_hamiltonian, state_charges_vector  # noqa: E402
from repro.core.mps import MPS as JaxMPS  # noqa: E402
from repro_torch.convert import mps_from_arrays  # noqa: E402
from repro_torch.core import measure  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402

from _torch_helpers import jax_from_arrays, to_arrays  # noqa: E402

ED_TOL = 1e-8  # against ED; the reference test allows 1e-7

N = 6


def j1j2_3x2(pkg):
    return pkg.spin_half_space(), pkg.heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)


@pytest.fixture(scope="module")
def state():
    """The reference's ground state in both packages, and the ED ground
    state in the Sz=0 sector."""
    from repro.core.dmrg import run_dmrg

    jsp, terms = j1j2_3x2(jmodels)
    res = run_dmrg(jsp, terms, N, bond_schedule=(8, 16), sweeps_per_bond=2, davidson_iters=6)
    H = build_dense_hamiltonian(jsp, terms, N)
    mask = np.all(state_charges_vector(jsp, N) == np.array((0,)), axis=1)
    psi = np.zeros(2**N)
    psi[mask] = np.linalg.eigh(H[np.ix_(mask, mask)])[1][:, 0]
    arrays = [to_arrays(t) for t in res.mps.tensors]
    jmps = JaxMPS([jax_from_arrays(t) for t in arrays])
    return jsp, jmps, tmodels.spin_half_space(), mps_from_arrays(arrays, device="cpu"), psi


def _ed_op(op, site, d=2):
    m = np.ones((1, 1))
    for s in range(N):
        m = np.kron(m, op if s == site else np.eye(d))
    return m


def test_sz_expectation_matches_ed_and_reference(state):
    jsp, jmps, sp, mps, psi = state
    sz = np.asarray(sp.ops["Sz"])
    for site in (0, 2, 5):
        got = measure.site_expectation(mps, sp, "Sz", site)
        assert abs(got - jmeasure.site_expectation(jmps, jsp, "Sz", site)) <= 1e-12
        assert abs(got - float(psi @ _ed_op(sz, site) @ psi)) <= ED_TOL
    total = sum(measure.site_expectation(mps, sp, "Sz", i) for i in range(N))
    assert abs(total) <= 1e-8  # the state's charge: Sz = 0


def test_szsz_correlation_and_profile_match_ed_and_reference(state):
    jsp, jmps, sp, mps, psi = state
    sz = np.asarray(sp.ops["Sz"])
    for i, j in ((0, 1), (1, 4), (0, 5)):
        got = measure.correlation(mps, sp, "Sz", "Sz", i, j)
        assert abs(got - jmeasure.correlation(jmps, jsp, "Sz", "Sz", i, j)) <= 1e-12
        assert abs(got - float(psi @ (_ed_op(sz, i) @ _ed_op(sz, j)) @ psi)) <= ED_TOL
    got = measure.correlation_profile(mps, sp, "Sz", "Sz", ref=1)
    want = jmeasure.correlation_profile(jmps, jsp, "Sz", "Sz", ref=1)
    assert [r for r, _ in got] == [r for r, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="i < j"):
        measure.correlation(mps, sp, "Sz", "Sz", 3, 3)


def test_spsm_correlation_matches_ed_and_reference(state):
    """A charged operator string, S+_i S-_j: the environments between the
    two points carry the charge."""
    jsp, jmps, sp, mps, psi = state
    spo, smo = np.asarray(sp.ops["S+"]), np.asarray(sp.ops["S-"])
    for i, j in ((0, 3), (2, 5)):
        got = measure.correlation(mps, sp, "S+", "S-", i, j)
        assert abs(got - jmeasure.correlation(jmps, jsp, "S+", "S-", i, j)) <= 1e-12
        assert abs(got - float(psi @ (_ed_op(spo, i) @ _ed_op(smo, j)) @ psi)) <= ED_TOL
