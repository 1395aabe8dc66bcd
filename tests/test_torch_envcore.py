"""The port's environment engine (``dist/envcore.py``, fused environment
updates replayed through the graph cache, eager on the CPU) and its plan
(``dist/plan.py``), held against the three-call ``extend_left`` /
``extend_right`` of both packages on the same numpy inputs.

Mirrors ``tests/test_env.py``: fused == seed block for block (<=1e-12),
the unpadded core, output structure, the planned right-to-left rebuild, plan
cache hits and distinct left/right plans, the sweep's ``jit_env`` knob; and
the environment plan's tables against the JAX plan's.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import env as jenv  # noqa: E402
from repro.dist.plan import EnvironmentPlan as JaxEnvPlan, PlanCache as JaxPlanCache  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.core.env import extend_left, extend_right, left_edge, right_edge  # noqa: E402
from repro_torch.core.mpo import build_mpo, compress_mpo  # noqa: E402
from repro_torch.core.mps import neel_states, product_state_mps  # noqa: E402
from repro_torch.core.sweep import DMRGEngine  # noqa: E402
from repro_torch.dist.batch import pad_block_sparse  # noqa: E402
from repro_torch.dist.envcore import EnvironmentEngine, env_out_indices  # noqa: E402
from repro_torch.dist.plan import EnvironmentPlan, EnvPlanCache, PlanCache  # noqa: E402
from repro_torch.tensor.blocksparse import contract  # noqa: E402

from _torch_helpers import assert_blocks_close, jax_from_arrays, specs, to_arrays  # noqa: E402

N = 6


def _system():
    sp = tmodels.spin_half_space()
    terms = tmodels.heisenberg_j1j2_terms(N // 2, 2, 1.0, 0.5, cylinder=False)
    return sp, compress_mpo(build_mpo(sp, terms, N, device="cpu"), cutoff=1e-13)


def _converged(algo="list", sweeps=2, m=8, **kw):
    sp, mpo = _system()
    eng = DMRGEngine(product_state_mps(sp, neel_states(sp, N), device="cpu"), mpo, davidson_iters=2,
                     algo=algo, device="cpu", **kw)
    for _ in range(sweeps):
        eng.sweep(max_bond=m)
    return eng


@pytest.fixture(scope="module")
def state():
    eng = _converged(jit_env=False)
    return eng.mps.tensors, eng.mpo


@pytest.mark.parametrize("algo", ["list", "batched", "csr"])
def test_fused_equals_the_three_call_update(state, algo):
    """Planned fused updates == extend_left / extend_right of the port and
    of the reference, block for block (<=1e-12), over a full left and right
    pass, through every engine backend."""
    from repro_torch.core.env import get_contractor

    T, W = state
    ceng = get_contractor(algo, "cpu")
    jT, jW = [jax_from_arrays(to_arrays(t)) for t in T], [jax_from_arrays(to_arrays(w)) for w in W]
    A_ref = A_got = left_edge(T[0], W[0])
    jA = jenv.left_edge(jT[0], jW[0])
    for j in range(N - 1):
        A_ref, A_got = extend_left(A_ref, T[j], W[j], contract), ceng.env_update_left(A_got, T[j], W[j])
        jA = jenv.extend_left(jA, jT[j], jW[j])
        assert_blocks_close(A_got, A_ref, 1e-12)
        assert_blocks_close(A_got, jA, 1e-12)
    B_ref = B_got = right_edge(T[N - 1], W[N - 1])
    jB = jenv.right_edge(jT[N - 1], jW[N - 1])
    for j in range(N - 1, 0, -1):
        B_ref, B_got = extend_right(B_ref, T[j], W[j], contract), ceng.env_update_right(B_got, T[j], W[j])
        jB = jenv.extend_right(jB, jT[j], jW[j])
        assert_blocks_close(B_got, B_ref, 1e-12)
        assert_blocks_close(B_got, jB, 1e-12)
    assert ceng.stats()["env"]["env_updates"] == 2 * (N - 1)


@pytest.mark.parametrize("kw", [dict(pad=False), dict(jit=False), dict(pad=False, jit=False)])
def test_unpadded_and_eager_cores_match_too(state, kw):
    T, W = state
    ee = EnvironmentEngine(EnvPlanCache(), **kw)
    A_ref = A_got = left_edge(T[0], W[0])
    for j in range(N - 1):
        A_ref, A_got = extend_left(A_ref, T[j], W[j], contract), ee.update_left(A_got, T[j], W[j])
        assert_blocks_close(A_got, A_ref, 1e-12)


def test_out_indices_match_the_seed_structure(state):
    T, W = state
    assert env_out_indices(T[0], W[0], "left") == extend_left(left_edge(T[0], W[0]), T[0], W[0]).indices
    n = N - 1
    assert env_out_indices(T[n], W[n], "right") == extend_right(right_edge(T[n], W[n]), T[n], W[n]).indices


def test_env_plan_tables_match_jax_plan(state):
    """Operand keys, output keys, the step-3 key of each output, the final
    transpose and each step's pair table equal the JAX plan's (on padded
    operands, as the engine builds them)."""
    T, W = state
    A = extend_left(left_edge(T[0], W[0]), T[0], W[0])
    B = extend_right(right_edge(T[N - 1], W[N - 1]), T[N - 1], W[N - 1])
    for side, env, j in (("left", A, 1), ("right", B, N - 2)):
        ops = [pad_block_sparse(t) for t in (env, T[j], W[j])]
        got = EnvironmentPlan.build(*ops, side, PlanCache())
        want = JaxEnvPlan.build(*[jax_from_arrays(to_arrays(t)) for t in ops], side, cache=JaxPlanCache())
        for name in ("side", "perm", "env_keys", "site_keys", "mpo_keys", "out_keys", "pre_out_keys", "out_charge", "flops"):
            assert getattr(got, name) == getattr(want, name), name
        assert specs(got.out_indices) == specs(want.out_indices)
        for g, w in zip(got.steps, want.steps):
            assert g.pairs == w.pairs and g.out_keys == w.out_keys


def test_plan_cache_hits_and_distinct_left_right_plans(state):
    T, W = state
    ee = EnvironmentEngine(EnvPlanCache())
    A = left_edge(T[0], W[0])
    ee.update_left(A, T[0], W[0])
    assert ee.cache.stats() == {"hits": 0, "misses": 1, "evictions": 0, "builds": 1, "size": 1}
    ee.update_left(A, T[0], W[0])
    assert ee.cache.stats() == {"hits": 1, "misses": 1, "evictions": 0, "builds": 1, "size": 1}
    ee.update_right(right_edge(T[N - 1], W[N - 1]), T[N - 1], W[N - 1])
    assert ee.cache.stats()["misses"] == 2 and ee.cache.stats()["size"] == 2


def test_init_envs_as_a_planned_pass_match_the_seed_rebuild():
    sp, mpo = _system()
    on = DMRGEngine(product_state_mps(sp, neel_states(sp, N), device="cpu"), mpo, algo="batched", device="cpu")
    off = DMRGEngine(product_state_mps(sp, neel_states(sp, N), device="cpu"), mpo, algo="batched", jit_env=False,
                     device="cpu")
    assert on.jit_env and not off.jit_env
    for e_on, e_off in zip(on.right_envs, off.right_envs):
        if e_on is None or e_off is None:
            assert e_on is e_off
        else:
            assert_blocks_close(e_on, e_off, 1e-12)


def test_sweep_reports_the_env_stage():
    eng = _converged(algo="batched", sweeps=0)
    s = eng.sweep(max_bond=8)
    assert 0 < s.env_seconds < s.seconds
    ledger = eng.contract_fn.stats()["env"]
    assert ledger["env_updates"] == (N - 2) + 2 * (N - 1)  # the startup rebuild, then one per pair
    assert ledger["env_flops"] > 0 and ledger["env_seconds"] > 0


def test_jit_env_on_and_off_agree():
    on, off = _converged(algo="batched", jit_env=True), _converged(algo="batched", jit_env=False)
    np.testing.assert_allclose(on.sweep(max_bond=8).energy, off.sweep(max_bond=8).energy, rtol=0, atol=1e-10)


def test_bare_contractors_refuse_the_engine_options():
    sp, mpo = _system()
    mps = product_state_mps(sp, neel_states(sp, N), device="cpu")
    for kw in (dict(jit_env=True), dict(jit_matvec=True), dict(svd_method="svd")):
        with pytest.raises(ValueError, match="requires a ContractionEngine"):
            DMRGEngine(mps, mpo, algo="list_unplanned", device="cpu", **kw)
    assert DMRGEngine(mps, mpo, algo="list_unplanned", device="cpu").jit_env is False
