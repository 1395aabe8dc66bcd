"""The paper's electron system (triangular Hubbard: t=1, U=8.5, d=4, two
U(1) charges (N, 2Sz), Jordan-Wigner strings in the MPO) through the port's
contraction paths, held against the JAX package and exact diagonalization.

The JAX reference run (``algo="list"``, seed SVD, three-call environment
updates) on the 4-site Hubbard chain at half filling is computed once per
module; every port path runs on the carried-across JAX MPO and must equal it
sweep by sweep (<1e-10) and ED (<=1e-8).  The MPO checks (the 3x2 patch
against the ED Hamiltonian, k=26 at width 6) are in
``test_torch_electrons_mpo.py``, so that the two sets of JAX work go to
different test workers.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import models as jmodels  # noqa: E402
from repro.core.mps import neel_states, total_charge  # noqa: E402
from repro_torch.convert import mpo_from_arrays  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.core.env import extend_left, extend_right, get_contractor, left_edge, right_edge  # noqa: E402
from repro_torch.dist.engine import MATVEC_AXES  # noqa: E402
from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref  # noqa: E402

from _torch_helpers import check_slice, jax_reference, work_emulate  # noqa: E402

N, BONDS = 4, (8, 16)
# the reference's own DMRG-vs-ED test of this chain (tests/test_dmrg.py)
# runs two sweeps per bond at eight Davidson iterations
RUN_KW = dict(sweeps_per_bond=2, davidson_iters=8)


def chain4(pkg):
    return pkg.electron_space(), pkg.triangular_hubbard_terms(4, 1, 1.0, 8.5, cylinder=False)


@pytest.fixture(scope="module")
def ref():
    space, terms = chain4(jmodels)
    return jax_reference(space, terms, N, BONDS, charge=total_charge(space, neel_states(space, N)), slice_kw=RUN_KW)


PATHS = {
    "list": dict(algo="list"),
    "csr": dict(algo="csr", svd_method="unplanned", jit_env=False),
    "batched": dict(algo="batched"),
    "auto": dict(algo="auto"),
    "batched_graphs": dict(algo="batched", jit_matvec=True),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_electrons_match_jax_and_ed(ref, path):
    """Every contraction path of the port: energies <1e-10 from the JAX run
    sweep by sweep, and <=1e-8 from ED at half filling (N=4, Sz=0)."""
    space, terms = chain4(tmodels)
    res = check_slice(ref, space, terms, N, BONDS, ed_tol=1e-8, slice_kw=RUN_KW, **PATHS[path])
    assert res.energies[-1] == pytest.approx(ref["energies"][-1], abs=1e-10)
    es = res.energies
    assert all(es[i + 1] <= es[i] + 1e-10 for i in range(len(es) - 1))
    if path != "list":
        # the host planner's block GEMM work lists, timed per sweep
        assert sum(s.work_lists for s in res.sweep_stats) > 0 and sum(s.work_list_ms for s in res.sweep_stats) > 0


def test_electron_matvec_through_the_kernel_planner(ref):
    """The middle-bond matvec of the converged chain, as the csr backend
    packs it for the block GEMM: each step's work list, run through a torch
    emulation of the kernel's two passes, equals the plain version (1e-13),
    with every pair on the skinny route (BK, BN <= 16 at m=16) and pairs of
    extent 1, as the card's tests take them from this system."""
    from repro_torch.convert import mps_from_arrays

    mpo = mpo_from_arrays(ref["mpo"], device="cpu")
    T = mps_from_arrays(ref["mps"], device="cpu").tensors
    engine = get_contractor("csr", "cpu")
    n, j = len(T), len(T) // 2 - 1
    A = left_edge(T[0], mpo[0])
    for i in range(j):
        A = extend_left(A, T[i], mpo[i], engine)
    B = right_edge(T[n - 1], mpo[n - 1])
    for i in range(n - 2, j, -1):
        B = extend_right(B, T[i + 1], mpo[i + 1], engine)
    t = engine(T[j], T[j + 1], ((2,), (0,)))
    routes, smallest = [], []
    for i, axes in enumerate(MATVEC_AXES):
        a, b = (A, t) if i == 0 else (t, (mpo[j], mpo[j + 1], B)[i - 1])
        plan = engine.cache.get(a, b, axes)
        lhs, rhs, oi, work, ext = engine.pack_csr(plan, a, b)
        O = len(plan.csr.out_keys)
        want = block_sparse_matmul_ref(lhs, rhs, oi, O)
        got = work_emulate(lhs, rhs, ext.numpy(), work, O)
        assert not got.isnan().any()
        assert (got - want).abs().max().item() <= 1e-13 * max(want.abs().max().item(), 1.0)
        routes.append(work.route)
        smallest.append(int(ext.min()))
        t = engine(a, b, axes)
    assert routes == ["skinny"] * len(MATVEC_AXES)
    assert min(smallest) == 1
