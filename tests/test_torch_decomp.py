"""The port's decomposition engine (``dist/decomp.py``, planned batched
truncated SVD) and its plan (``dist/plan.py``), held against the JAX
package on the same numpy inputs.

Mirrors ``tests/test_decomp.py``: gather tables identical to the JAX plan's,
planned == the reference's unplanned split up to the sign gauge, trunc_err
as the squared reconstruction error, the exact-tie truncation never above
``max_bond``, the randomized path against the exact top of the spectrum;
and the 3x2 open J1-J2 system through ``run_dmrg(algo="batched",
jit_matvec=True)`` against the reference's same call and ED.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import models as jmodels  # noqa: E402
from repro.dist.plan import DecompositionPlan as JaxDecompPlan  # noqa: E402
from repro.tensor import blocksparse as jbs  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.dist.decomp import DecompositionEngine  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402
from repro_torch.dist.plan import DecompositionPlan, DecompPlanCache, decomp_signature  # noqa: E402
from repro_torch.tensor import blocksparse as tbs  # noqa: E402
from repro_torch.tensor.qn import Index  # noqa: E402

from _torch_helpers import IN, OUT, check_slice, jax_reference, make_both, rand_sectors, specs  # noqa: E402


def rand_theta(seed, nq=1):
    """The same random 4-mode theta (a bra-like first mode, as in a DMRG
    pair) in both packages, with more than one block."""
    for s in range(seed, seed + 50):
        rng = np.random.default_rng(s)
        index_specs = [(rand_sectors(rng, nq), f, f"m{i}") for i, f in enumerate((IN, OUT, OUT, OUT))]
        j, t = make_both(s, index_specs, (0,) * nq)
        if t.num_blocks > 1:
            return j, t
    raise RuntimeError("no non-trivial theta found")


def dense(t) -> np.ndarray:
    return np.asarray(t.to_dense())


def recon(U, V, pkg, n_row_modes=2) -> np.ndarray:
    """Dense U·V over the bond: the gauge-invariant part of a split."""
    return dense(pkg.contract(U, V, ((n_row_modes,), (0,))))


def align_sign_gauge(U_ref, U, V):
    """U, V blocks (numpy) with each bond column's sign flipped to match
    U_ref's: LAPACK's singular-vector sign is unspecified."""
    bond_ax = U.ndim - 1
    bond = U.indices[bond_ax]
    u = {k: np.asarray(b) for k, b in U.blocks.items()}
    v = {k: np.asarray(b) for k, b in V.blocks.items()}
    for s in range(bond.num_sectors):
        m = bond.sector_dim(s)
        dots = np.zeros(m)
        for k, b in u.items():
            if k[bond_ax] == s and k in U_ref.blocks:
                dots += np.sum(np.asarray(U_ref.blocks[k]).reshape(-1, m) * b.reshape(-1, m), axis=0)
        flip = np.where(dots < 0, -1.0, 1.0)
        for k in u:
            if k[bond_ax] == s:
                u[k] = u[k] * flip
        for k in v:
            if k[0] == s:
                v[k] = v[k] * flip.reshape((-1,) + (1,) * (V.ndim - 1))
    return u, v


def test_gather_tables_match_jax_plan():
    """Block order and offsets, sector layouts, bucket shapes, stack slots,
    gather tables and true ranks equal the JAX plan's."""
    for seed in (3, 8, 40):
        jt, tt = rand_theta(seed)
        want, got = JaxDecompPlan.build(jt, 2), DecompositionPlan.build(tt, 2)
        assert (got.block_order, got.block_offsets, got.nnz) == (want.block_order, want.block_offsets, want.nnz)
        assert got.svd_flops == want.svd_flops
        for g, w in zip(got.sectors, want.sectors, strict=True):
            for name in ("q", "row_keys", "col_keys", "rdims", "cdims", "roffs", "coffs", "R", "C", "bucket", "slot"):
                assert getattr(g, name) == getattr(w, name), name
        for g, w in zip(got.buckets, want.buckets, strict=True):
            assert (g.rp, g.cp, g.sectors) == (w.rp, w.cp, w.sectors)
            np.testing.assert_array_equal(g.gather, w.gather)
            np.testing.assert_array_equal(g.k_true, w.k_true)


def test_gather_reproduces_the_sector_matrices():
    """One gather from the flat blocks gives each sector's padded [R, C]
    matrix (zero beyond it); the trimmed device table keeps all of it."""
    _, tt = rand_theta(3)
    plan = DecompositionPlan.build(tt, 2)
    flat = np.concatenate([tt.blocks[k].numpy().reshape(-1) for k in plan.block_order] + [np.zeros(1)])
    dense_theta = tt.to_dense().numpy()
    offs = [ix.offsets() for ix in tt.indices]
    for bucket in plan.buckets:
        mats = flat[bucket.gather]
        trimmed, _ = bucket.device_tables(torch.device("cpu"))
        np.testing.assert_array_equal(
            flat[trimmed.numpy()].reshape(len(bucket.sectors), bucket.rmax, bucket.cmax),
            mats[:, : bucket.rmax, : bucket.cmax])
        assert not mats[:, bucket.rmax:, :].any() and not mats[:, :, bucket.cmax:].any()
        for slot, si in enumerate(bucket.sectors):
            sec = plan.sectors[si]
            for rk, rd, ro in zip(sec.row_keys, sec.rdims, sec.roffs):
                for ck, cd, co in zip(sec.col_keys, sec.cdims, sec.coffs):
                    sl = tuple(slice(offs[i][s], offs[i][s] + tt.indices[i].sector_dim(s)) for i, s in enumerate(rk + ck))
                    np.testing.assert_array_equal(mats[slot, ro:ro + rd, co:co + cd], dense_theta[sl].reshape(rd, cd))
            assert not mats[slot, sec.R:, :].any() and not mats[slot, :, sec.C:].any()


def test_every_sector_in_exactly_one_bucket_slot():
    _, tt = rand_theta(7)
    plan = DecompositionPlan.build(tt, 2)
    assert sorted(si for b in plan.buckets for si in b.sectors) == list(range(plan.num_sectors))
    for si, sec in enumerate(plan.sectors):
        b = plan.buckets[sec.bucket]
        assert b.sectors[sec.slot] == si and b.rp >= sec.R and b.cp >= sec.C
        assert b.rmax >= sec.R and b.cmax >= sec.C


def test_plan_cache_semantics():
    _, tt = rand_theta(0)
    cache = DecompPlanCache()
    p1 = cache.get(tt, 2)
    t2 = tbs.BlockSparseTensor(tt.indices, {k: 2.0 * b for k, b in tt.blocks.items()}, tt.charge)
    assert cache.get(t2, 2) is p1
    cache.get(tt, 1)
    assert cache.stats() == {"hits": 1, "misses": 2, "evictions": 0, "builds": 2, "size": 2}
    assert decomp_signature(tt, 1) != decomp_signature(tt, 2)


@pytest.mark.parametrize("seed,max_bond", [(s, mb) for s, mb in zip(range(10, 22), (1, 2, 3, 4, 5, 6, 8, 10, 12, 3, 7, 12))])
def test_planned_equals_unplanned_up_to_gauge(seed, max_bond):
    """The port's planned split against the reference's unplanned one:
    bond structure, block keys, singular values and trunc_err equal, and
    every U and V block equal once the sign gauge is aligned (<=1e-10)."""
    jt, tt = rand_theta(seed)
    U_r, V_r, sv_r, err_r = jbs.svd_split_unplanned(jt, 2, max_bond=max_bond, cutoff=0.0)
    U, V, sv, err = DecompositionEngine().svd_split(tt, 2, max_bond=max_bond, cutoff=0.0)
    assert specs(U.indices) == specs(U_r.indices) and specs(V.indices) == specs(V_r.indices)
    assert set(U.blocks) == set(U_r.blocks) and set(V.blocks) == set(V_r.blocks)
    assert set(sv) == set(sv_r)
    for q in sv_r:
        np.testing.assert_allclose(sv[q].numpy(), np.asarray(sv_r[q]), atol=1e-10)
    assert abs(err - err_r) < 1e-10
    u, v = align_sign_gauge(U_r, U, V)
    for k in U_r.blocks:
        np.testing.assert_allclose(u[k], np.asarray(U_r.blocks[k]), atol=1e-10)
    for k in V_r.blocks:
        np.testing.assert_allclose(v[k], np.asarray(V_r.blocks[k]), atol=1e-10)


@pytest.mark.parametrize("seed,max_bond", [(30, 2), (31, 5), (32, 9)])
def test_trunc_err_is_the_squared_reconstruction_error(seed, max_bond):
    _, tt = rand_theta(seed)
    U, V, _, err = DecompositionEngine().svd_split(tt, 2, max_bond=max_bond, cutoff=0.0)
    actual = float(np.sum((recon(U, V, tbs) - dense(tt)) ** 2))
    np.testing.assert_allclose(actual, err, rtol=1e-8, atol=1e-12)


def test_absorb_left_and_right_agree_up_to_gauge():
    _, tt = rand_theta(5)
    eng = DecompositionEngine()
    U_r, V_r, sv_r, err_r = eng.svd_split(tt, 2, max_bond=6, absorb="right")
    U_l, V_l, sv_l, err_l = eng.svd_split(tt, 2, max_bond=6, absorb="left")
    np.testing.assert_allclose(recon(U_r, V_r, tbs), recon(U_l, V_l, tbs), atol=1e-11)
    assert U_r.indices[-1] == U_l.indices[-1] and err_r == err_l
    for q in sv_r:
        np.testing.assert_allclose(sv_r[q].numpy(), sv_l[q].numpy(), atol=1e-12)
    U, V, _, _ = eng.svd_split(tt, 2, max_bond=8, absorb="none")  # both isometric
    gram_u = dense(tbs.contract(U.conj(), U, ((0, 1), (0, 1))))
    gram_v = dense(tbs.contract(V, V.conj(), ((1, 2), (1, 2))))
    np.testing.assert_allclose(gram_u, np.eye(len(gram_u)), atol=1e-11)
    np.testing.assert_allclose(gram_v, np.eye(len(gram_v)), atol=1e-11)


def test_exact_ties_keep_at_most_max_bond_deterministically():
    """Two sectors with identical spectra {1, 0.5}: the planned truncation
    keeps exactly max_bond values, two from the first sector in charge
    order and one from the second, as the reference's planned split does."""
    from repro.tensor import qn as jqn

    sectors, d = (((0,), 2), ((1,), 2)), np.diag([1.0, 0.5])
    theta = tbs.BlockSparseTensor([Index(sectors, IN), Index(sectors, OUT)],
                                  {(0, 0): torch.from_numpy(d), (1, 1): torch.from_numpy(d)})
    jtheta = jbs.BlockSparseTensor([jqn.Index(sectors, IN), jqn.Index(sectors, OUT)], {(0, 0): d, (1, 1): d})
    eng = DecompositionEngine()
    U, _, svals, _ = eng.svd_split(theta, 1, max_bond=3, cutoff=0.0)
    kept = {q: len(v) for q, v in svals.items()}
    assert U.indices[-1].dim == 3 and kept == {(-1,): 2, (0,): 1}
    assert kept == {q: len(v) for q, v in jbs.svd_split(jtheta, 1, max_bond=3, cutoff=0.0)[2].items()}
    again = eng.svd_split(theta, 1, max_bond=3, cutoff=0.0)[0]
    for k in U.blocks:
        assert torch.equal(U.blocks[k], again.blocks[k])


def _decaying_theta(R=96, C=80):
    """One sector with an exponentially decaying spectrum."""
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.normal(size=(R, R)))
    v, _ = np.linalg.qr(rng.normal(size=(C, C)))
    s = 2.0 ** -np.arange(min(R, C), dtype=np.float64)
    mat = (u[:, : len(s)] * s) @ v[: len(s), :]
    return tbs.BlockSparseTensor([Index((((0,), R),), IN), Index((((0,), C),), OUT)], {(0, 0): torch.from_numpy(mat)})


def test_randomized_matches_exact_top_of_spectrum():
    theta = _decaying_theta()
    exact = DecompositionEngine(DecompPlanCache(), method="svd")
    rand = DecompositionEngine(DecompPlanCache(), method="randomized")
    _, _, sv_e, err_e = exact.svd_split(theta, 1, 8, cutoff=0.0)
    _, _, sv_r, err_r = rand.svd_split(theta, 1, 8, cutoff=0.0)
    assert rand.rsvd_buckets == 1 and exact.rsvd_buckets == 0
    np.testing.assert_allclose(sv_r[(0,)].numpy(), sv_e[(0,)].numpy(), rtol=1e-8)
    assert err_r <= err_e + 1e-12


def test_randomized_takes_the_exact_svd_where_the_sketch_covers_the_rank():
    jt, tt = rand_theta(4)
    eng = DecompositionEngine(DecompPlanCache(), method="randomized")
    U, V, _, err = eng.svd_split(tt, 2, max_bond=8, cutoff=0.0)
    assert eng.rsvd_buckets == 0
    U_r, V_r, _, err_r = jbs.svd_split_unplanned(jt, 2, max_bond=8, cutoff=0.0)
    np.testing.assert_allclose(recon(U, V, tbs), recon(U_r, V_r, jbs), atol=1e-10)
    assert abs(err - err_r) < 1e-10


def test_auto_prefers_the_randomized_svd_only_on_large_buckets():
    eng = DecompositionEngine(DecompPlanCache(), method="auto")
    assert set(eng._bucket_methods(eng.cache.get(rand_theta(4)[1], 2), 8)[0]) == {"svd"}
    methods, sketch = eng._bucket_methods(eng.cache.get(_decaying_theta(512, 512), 1), 8)
    assert "rsvd" in methods and sketch == 8 + eng.rsvd_oversample


def test_contraction_engine_routes_svd_split_and_reports():
    _, tt = rand_theta(2)
    eng = ContractionEngine("batched")
    eng.svd_split(tt, 2, max_bond=8)
    eng.svd_split(tt, 2, max_bond=8)
    st = eng.stats()["decomp"]
    assert st["svd_calls"] == 2 and st["svd_flops"] > 0 and st["svd_seconds"] > 0
    assert st["sectors"] >= st["buckets"] >= 2
    assert st["host_syncs"] == 0  # counted on the card only
    assert st["plan_cache"] == {"hits": 1, "misses": 1, "evictions": 0, "builds": 1, "size": 1}


N, BONDS = 6, (8,)
RUN_KW = dict(algo="batched", jit_matvec=True)


def j1j2_3x2(pkg):
    return pkg.spin_half_space(), pkg.heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)


@pytest.fixture(scope="module")
def ref():
    return jax_reference(*j1j2_3x2(jmodels), N, BONDS, **RUN_KW)


def test_batched_jit_3x2_matches_jax_and_ed(ref):
    """run_dmrg(algo="batched", jit_matvec=True) with the reference's
    defaults (planned SVD, fused env updates): <1e-10 from the reference's
    same call, <=1e-8 from ED."""
    res = check_slice(ref, *j1j2_3x2(tmodels), N, BONDS, ed_tol=1e-8, **RUN_KW)
    assert res.sweep_stats[-1].svd_seconds > 0
