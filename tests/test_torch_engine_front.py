"""The port's engine front door (``dist/engine.py`` backends and cost
model, ``tensor/blocksparse.py``, ``core/env.get_contractor``,
``core/mps.py``), held against the JAX package on the same numpy inputs.

Mirrors the backend-equality cases of ``tests/test_dist.py``: every backend
block for block against the reference's same call (<=1e-12), "auto"
choosing what the reference's cost model chooses per plan, and DMRG
energies through "dense", "auto" and the seed algorithms <1e-10 from the
reference's same run.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import env as jenv  # noqa: E402
from repro.core import models as jmodels  # noqa: E402
from repro.core import mps as jmps  # noqa: E402
from repro.dist.engine import ContractionEngine as JaxEngine  # noqa: E402
from repro.dist.plan import ContractionPlan as JaxPlan  # noqa: E402
from repro.dist.plan import PlanCache as JaxPlanCache  # noqa: E402
from repro.tensor import blocksparse as jbs  # noqa: E402
from repro_torch.convert import mps_from_arrays  # noqa: E402
from repro_torch.core import env as tenv  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.core import mps as tmps  # noqa: E402
from repro_torch.dist.engine import BACKENDS, ContractionEngine  # noqa: E402
from repro_torch.dist.plan import ContractionPlan, PlanCache  # noqa: E402
from repro_torch.tensor import blocksparse as tbs  # noqa: E402

from _torch_helpers import (  # noqa: E402
    CASES, IN, OUT, SLICE_KW, assert_blocks_close, check_slice, jax_reference, make_both, rand_sectors, to_arrays,
)

AX = ((1,), (0,))
N, BONDS = 6, (8, 16)


def j1j2_3x2(pkg):
    return pkg.spin_half_space(), pkg.heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)


def rand_pair(seed, nq=1):
    """The same random (A [a, s], B [s*, b]) in both packages, charge zero,
    with at least one block pair."""
    rng = np.random.default_rng(seed)
    shared = rand_sectors(rng, nq, max_sectors=4)

    def subset(sign):
        keep = [sec for sec in shared if rng.random() < 0.7] or [shared[0]]
        return tuple((tuple(sign * c for c in q), int(rng.integers(1, 5))) for q, _ in keep)

    q0 = (0,) * nq
    ja, ta = make_both(seed, [(subset(-1), OUT, "a"), (shared, OUT, "s")], q0)
    jb, tb = make_both(seed + 1, [(shared, IN, "s"), (subset(1), OUT, "b")], q0)
    return (ja, jb), (ta, tb)


def higher_order_pair(seed):
    """3-mode tensors contracting two modes: A [i1, i2, i3], B [i2*, i3*, i1]."""
    rng = np.random.default_rng(seed)
    s1, s2, s3 = (rand_sectors(rng, max_dim=5) for _ in range(3))
    ja, ta = make_both(seed, [(s1, OUT, "1"), (s2, OUT, "2"), (s3, OUT, "3")], (0,))
    jb, tb = make_both(seed + 1, [(s2, IN, "2"), (s3, IN, "3"), (s1, OUT, "1")], (0,))
    return (ja, jb), (ta, tb), ((1, 2), (0, 1))


def wide_pair(seed):
    """A [x, y*, s] and B [s*, z, w*] contracting s: every block meets
    several partners, so the batched backend's fewer dispatches can win."""
    rng = np.random.default_rng(seed)
    ns, hi = int(rng.integers(2, 5)), int(rng.integers(1, 4))

    def sec():
        return tuple(((q,), int(rng.integers(1, hi + 1))) for q in range(-(ns // 2), ns - ns // 2))

    sx, sy, ss, sz, sw = (sec() for _ in range(5))
    ja, ta = make_both(seed, [(sx, OUT, "x"), (sy, IN, "y"), (ss, OUT, "s")], (0,))
    jb, tb = make_both(seed + 1, [(ss, IN, "s"), (sz, OUT, "z"), (sw, IN, "w")], (0,))
    return (ja, jb), (ta, tb), ((2,), (0,))


@pytest.mark.parametrize("seed", range(4))
def test_dense_block_for_block(seed):
    """The dense backend against the reference's dense backend and its
    ``contract_dense``, block for block (zero blocks included), <=1e-12."""
    (ja, jb), (ta, tb) = rand_pair(seed)
    got = ContractionEngine("dense", PlanCache())(ta, tb, AX)
    assert_blocks_close(got, JaxEngine("dense", JaxPlanCache())(ja, jb, AX), 1e-12)
    assert_blocks_close(tbs.contract_dense(ta, tb, AX), jbs.contract_dense(ja, jb, AX), 1e-12)


@pytest.mark.parametrize("backend", ["list", "dense", "csr", "batched", "auto"])
def test_higher_order_all_backends(backend):
    """Each backend (csr on its plain version) on a two-mode contraction of
    3-mode tensors against the reference's same backend, block for block."""
    (ja, jb), (ta, tb), ax = higher_order_pair(7)
    got = ContractionEngine(backend, PlanCache(), use_kernel=False)(ta, tb, ax)
    want = JaxEngine(backend, JaxPlanCache(), use_kernel=False)(ja, jb, ax)
    assert_blocks_close(got, want, 1e-12)
    np.testing.assert_allclose(got.to_dense().numpy(), np.asarray(jbs.contract(ja, jb, ax).to_dense()), atol=1e-12)


@pytest.mark.parametrize("allow_csr", [False, True])
def test_choose_backend_equals_reference(allow_csr):
    """On the same random contractions (two-mode, higher order, one and two
    charges, several overheads) the cost model chooses as the reference's,
    and all its candidates occur.
    The generic random shapes never favour dense, so each plan is also
    priced with its dense embedding made free (``flops_dense`` and
    ``num_in_blocks`` zeroed in both packages' plans alike).
    """
    seen = set()
    cases = ([rand_pair(s, nq=1 + s % 2) + (AX,) for s in range(16)] + [higher_order_pair(s) for s in range(8)]
             + [wide_pair(s) for s in range(6)])
    for (ja, jb), (ta, tb), ax in cases:
        plans = ContractionPlan.build(ta, tb, ax), JaxPlan.build(ja, jb, ax)
        free = tuple(dataclasses.replace(p, flops_dense=0.0, num_in_blocks=0) for p in plans)
        for overhead in (0.0, 1e2, 16384.0, 1e6):
            kw = dict(allow_csr=allow_csr, pair_overhead=overhead)
            got, want = ContractionEngine("auto", **kw), JaxEngine("auto", JaxPlanCache(), **kw)
            for p, q in (plans, free):
                choice = got.choose_backend(p)
                assert choice == want.choose_backend(q)
                seen.add(choice)
    # with csr allowed, its single launch undercuts batched on these shapes
    assert seen == ({"list", "dense", "csr"} if allow_csr else {"list", "dense", "batched"})


def test_auto_backend_counts_equal_reference():
    """A 6-site run through "auto" (eager matvec) dispatches every
    contraction to the same backends as the reference's same run."""
    from repro.core.dmrg import run_dmrg as jax_run_dmrg
    from repro.core.mpo import build_mpo, compress_mpo
    from repro_torch.convert import mpo_from_arrays
    from repro_torch.core.dmrg import run_dmrg
    from repro_torch.core.sweep import DMRGEngine

    jmpo = compress_mpo(build_mpo(*j1j2_3x2(jmodels), N), cutoff=1e-13)
    jeng = jenv.get_contractor("auto")
    import repro.core.sweep as jsweep

    jax_engine = jsweep.DMRGEngine(jmps.product_state_mps(jmodels.spin_half_space(), jmps.neel_states(
        jmodels.spin_half_space(), N)), jmpo, algo="auto", davidson_iters=4, engine=jeng)
    mpo = mpo_from_arrays([to_arrays(w) for w in jmpo], device="cpu")
    sp = tmodels.spin_half_space()
    eng = DMRGEngine(tmps.product_state_mps(sp, tmps.neel_states(sp, N), device="cpu"), mpo, algo="auto",
                     davidson_iters=4, device="cpu")
    for m in BONDS:
        s_ref, s_got = jax_engine.sweep(max_bond=m), eng.sweep(max_bond=m)
        assert s_got.davidson_restarts == s_ref.davidson_restarts
        assert s_got.davidson_iterations == s_ref.davidson_iterations
        assert abs(s_got.energy - s_ref.energy) < 1e-10
    got, want = eng.contract_fn.backend_counts, jeng.backend_counts
    assert got == want and set(got) == set(BACKENDS) | {"spmd"} and want["spmd"] == 0
    assert sum(got.values()) > 0 and eng.contract_fn.retries == {}
    assert run_dmrg  # the entry point is exercised by test_energies_equal_reference


@pytest.fixture(scope="module", params=["dense", "auto", "dense_unplanned", "csr_unplanned"])
def algo_ref(request):
    return request.param, jax_reference(*j1j2_3x2(jmodels), N, (8,), algo=request.param)


def test_energies_equal_reference(algo_ref):
    """Energies through each algorithm <1e-10 from the reference's same
    run (m=8, exact on 6 sites), and <=1e-8 from exact diagonalization."""
    algo, ref = algo_ref
    check_slice(ref, *j1j2_3x2(tmodels), N, (8,), algo, ed_tol=1e-8)


def test_planned_is_auto():
    eng = tenv.get_contractor("planned", device="cpu")
    assert isinstance(eng, ContractionEngine) and eng.backend == "auto"


def test_get_contractor_accepts_the_reference_names():
    """Every name the reference's ``get_contractor`` accepts, and the same
    refusal of an unknown one; the engine takes every backend."""
    for algo in tenv.ALGOS:
        assert callable(jenv.get_contractor(algo)) and callable(tenv.get_contractor(algo, device="cpu"))
    for get in (jenv.get_contractor, lambda a: tenv.get_contractor(a, device="cpu")):
        with pytest.raises(ValueError, match="unknown contraction algorithm"):
            get("sparse")
    for backend in BACKENDS + ("auto",):
        assert ContractionEngine(backend).backend == backend
    with pytest.raises(ValueError, match="unknown backend"):
        ContractionEngine("spmd")


def test_auto_graphed_matvec_equals_eager():
    """Under "auto" the graph pipeline (eager on the CPU) routes each step by
    ``choose_backend`` and equals the eager matvec."""
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.core.sweep import DMRGEngine
    from repro_torch.dist.batch import pad_block_sparse
    from repro_torch.dist.engine import MATVEC_AXES

    sp, terms = j1j2_3x2(tmodels)
    mpo = compress_mpo(build_mpo(sp, terms, N, device="cpu"), cutoff=1e-13)
    run = DMRGEngine(tmps.product_state_mps(sp, tmps.neel_states(sp, N), device="cpu"), mpo, algo="auto",
                     jit_matvec=True, davidson_iters=2, device="cpu")
    run.sweep(max_bond=8)
    engine, j, T = run.contract_fn, 2, run.mps.tensors
    A = run.left_envs[0]
    for i in range(j):
        A = engine.env_update_left(A, T[i], mpo[i])
    ops = tuple(pad_block_sparse(t) for t in (A, mpo[j], mpo[j + 1], run.right_envs[j + 1]))
    x = pad_block_sparse(engine(T[j], T[j + 1], ((2,), (0,))))
    counts = dict(engine.backend_counts)
    got = engine.matvec_fn(*ops, jit=True)(x)
    steps = [engine.backend_for(p) for p in engine._prepare_chain(x, ops, x.device)]
    assert {k: engine.backend_counts[k] - counts[k] for k in counts} == {b: steps.count(b) for b in counts}
    assert_blocks_close(got, engine.matvec_fn(*ops, jit=False)(x), 1e-12)
    assert len(MATVEC_AXES) == len(steps)


def test_right_canonicalize_equals_reference():
    """The same bond dims as the reference's, the state contracted to dense
    equal up to a global sign, and every site but the first an isometry."""
    ref = jax_reference(*j1j2_3x2(jmodels), N, (8,), algo="list")
    jstate = jmps.MPS([jbs.BlockSparseTensor(*_jax_args(t)) for t in ref["mps"]])
    want = jmps.right_canonicalize(jstate)
    got = tmps.right_canonicalize(mps_from_arrays(ref["mps"], device="cpu"))
    assert got.bond_dims() == want.bond_dims()
    psi_got, psi_want = _dense_state(got.tensors), _dense_state(want.tensors)
    sign = np.sign(np.vdot(psi_want, psi_got))
    np.testing.assert_allclose(sign * psi_got, psi_want, atol=1e-12)
    assert abs(float(got.norm_sq()) - float(np.asarray(want.norm_sq()))) < 1e-12
    for t in got.tensors[1:]:
        rows = tbs.contract(t, t.conj(), ((1, 2), (1, 2))).to_dense().numpy()
        np.testing.assert_allclose(rows, np.eye(rows.shape[0]), atol=1e-12)


def _jax_args(arrays):
    from _torch_helpers import jax_from_arrays

    t = jax_from_arrays(arrays)
    return t.indices, t.blocks, t.charge


def _dense_state(tensors) -> np.ndarray:
    psi = np.asarray(tensors[0].to_dense())[0]  # (s, r) from the dim-1 left bond
    for t in tensors[1:]:
        psi = np.einsum("...r,rsk->...sk", psi, np.asarray(t.to_dense()))
    return psi.reshape(-1)


def test_mps_copy_and_total_blocks():
    ref = jax_reference(*j1j2_3x2(jmodels), N, (8,), algo="list")
    state = mps_from_arrays(ref["mps"], device="cpu")
    jstate = jmps.MPS([jbs.BlockSparseTensor(*_jax_args(t)) for t in ref["mps"]])
    assert state.total_blocks() == jstate.total_blocks()
    twin = state.copy()
    twin.tensors[0].blocks.clear()
    assert state.tensors[0].blocks and twin.tensors[0].blocks == {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scalar_product_nnz_and_valid_keys(case):
    """``__mul__`` / ``__rmul__``, ``nnz`` and ``is_valid_key`` as the
    reference's, on the same tensors."""
    a_specs, a_q = CASES[case][:2]
    j, t = make_both(4, a_specs, a_q)
    assert_blocks_close(2.5 * t, 2.5 * j, 0.0)
    assert_blocks_close(t * -1.0, j * -1.0, 0.0)
    assert t.nnz == j.nnz == sum(b.numel() for b in t.blocks.values())
    probe = tbs.BlockSparseTensor(t.indices, {}, t.charge)
    every = [(a, b, c) for a in range(t.indices[0].num_sectors) for b in range(t.indices[1].num_sectors)
             for c in range(t.indices[2].num_sectors)]
    assert [probe.is_valid_key(k) for k in every] == [j.is_valid_key(k) for k in every]
    assert sorted(k for k in every if probe.is_valid_key(k)) == sorted(probe.valid_keys())
