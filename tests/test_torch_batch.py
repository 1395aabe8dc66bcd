"""The port's batched backend (``dist/batch.py``), shape buckets
(``dist/plan.py``) and CUDA-graph cache (``dist/graphs.py``, eager on the
CPU), held against the JAX package on the same numpy inputs.

Mirrors ``tests/test_batch.py``: batched == list block for block, bucket
tables identical to the JAX plan's, pre-matricized operands == live ones,
power-of-two padding, and the graphed matvec's compile-once property; and
the Heisenberg chain (n=8, m=16) through ``run_dmrg(algo="batched",
jit_matvec=True)`` against the reference's same call and ED.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import models as jmodels  # noqa: E402
from repro.dist.plan import ContractionPlan as JaxPlan  # noqa: E402
from repro.tensor import blocksparse as jbs  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.dist import batch as tbatch  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402
from repro_torch.dist.plan import ContractionPlan, PlanCache, bucket_dim  # noqa: E402
from repro_torch.tensor import blocksparse as tbs  # noqa: E402
from repro_torch.tensor.qn import Index  # noqa: E402

from _torch_helpers import IN, OUT, assert_blocks_close, check_slice, jax_reference, make_both, rand_sectors  # noqa: E402

AX = ((1,), (0,))


def rand_pair(seed, nq=1):
    """The same random (A, B) in both packages, A [a, s] and B [s*, b] of
    charge zero, with at least one block pair: a's charges are the negated
    charges of a random subset of s's, b's a subset of s's, the dims random."""
    rng = np.random.default_rng(seed)
    shared = rand_sectors(rng, nq, max_sectors=4)

    def subset(sign):
        keep = [sec for sec in shared if rng.random() < 0.7] or [shared[0]]
        return tuple((tuple(sign * c for c in q), int(rng.integers(1, 5))) for q, _ in keep)

    q0 = (0,) * nq
    ja, ta = make_both(seed, [(subset(-1), OUT, "a"), (shared, OUT, "s")], q0)
    jb, tb = make_both(seed + 1, [(shared, IN, "s"), (subset(1), OUT, "b")], q0)
    assert JaxPlan.build(ja, jb, AX).pairs
    return (ja, jb), (ta, tb)


def higher_order_pair(seed):
    """3-mode tensors contracting two modes: A [i1, i2, i3], B [i2*, i3*, i1]."""
    rng = np.random.default_rng(seed)
    s1, s2, s3 = (rand_sectors(rng, max_dim=5) for _ in range(3))
    ja, ta = make_both(seed, [(s1, OUT, "1"), (s2, OUT, "2"), (s3, OUT, "3")], (0,))
    jb, tb = make_both(seed + 1, [(s2, IN, "2"), (s3, IN, "3"), (s1, OUT, "1")], (0,))
    return (ja, jb), (ta, tb), ((1, 2), (0, 1))


@pytest.mark.parametrize("seed,nq", [(s, 1) for s in range(8)] + [(s, 2) for s in range(100, 104)])
def test_batched_equals_list(seed, nq):
    """Batched == the reference's list contraction block for block, <=1e-13."""
    (ja, jb), (ta, tb) = rand_pair(seed, nq)
    got = ContractionEngine("batched", PlanCache())(ta, tb, AX)
    assert_blocks_close(got, jbs.contract(ja, jb, AX), 1e-13)


def test_higher_order_contraction():
    (ja, jb), (ta, tb), ax = higher_order_pair(3)
    got = ContractionEngine("batched", PlanCache())(ta, tb, ax)
    assert_blocks_close(got, jbs.contract(ja, jb, ax), 1e-12)


@pytest.mark.parametrize("case", ["pair", "higher_order"])
def test_bucket_tables_match_jax_plan(case):
    """Bucket keys and shapes, li/ri/oi, identity flags and out_keys equal
    the JAX plan's for the same structures."""
    if case == "pair":
        (ja, jb), (ta, tb) = rand_pair(11)
        ax = AX
    else:
        (ja, jb), (ta, tb), ax = higher_order_pair(5)
    want = JaxPlan.build(ja, jb, ax).batched
    got = ContractionPlan.build(ta, tb, ax).batched
    assert (got.num_buckets, got.num_unique, got.num_out_slots) == (want.num_buckets, want.num_unique, want.num_out_slots)
    for g, w in zip(got.buckets, want.buckets):
        assert (g.m, g.k, g.n) == (w.m, w.k, w.n)
        assert (g.a_keys, g.b_keys, g.out_keys) == (w.a_keys, w.b_keys, w.out_keys)
        for name in ("li", "ri", "oi"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert (g.li_identity, g.ri_identity) == (w.li_identity, w.ri_identity)
        assert list(g.oi) == sorted(g.oi)
        # the kernel's work list covers the bucket's exact shape
        assert g.work.shape == (len(g.oi), len(g.out_keys), g.m, g.k, g.n)


def test_precomputed_mats_match_live():
    (_, _), (ta, tb) = rand_pair(5)
    eng = ContractionEngine("batched", PlanCache())
    plan = eng.cache.get(ta, tb, AX)
    mats_a = tbatch.matricize_lhs(ta, plan.keep_a, plan.ax_a)
    mats_b = tbatch.matricize_rhs(tb, plan.keep_b, plan.ax_b)
    got = eng(ta, tb, AX, a_mats=mats_a, b_mats=mats_b)
    assert_blocks_close(got, eng(ta, tb, AX), 0.0)


def test_engine_stats_count_the_batched_backend():
    (_, _), (ta, tb) = rand_pair(2)
    eng = ContractionEngine("batched", PlanCache())
    eng(ta, tb, AX)
    st = eng.stats()
    assert st["backend_counts"] == {"list": 0, "dense": 0, "csr": 0, "batched": 1, "spmd": 0}
    assert st["backend_flops"]["batched"] > 0 and st["backend_seconds"]["batched"] > 0
    assert st["plan_cache"] == {"hits": 0, "misses": 1, "evictions": 0, "builds": 1, "size": 1}


def test_bucket_dim_powers_of_two():
    from repro.dist.plan import bucket_dim as jax_bucket_dim

    dims = (1, 2, 3, 4, 5, 9, 17, 1000, 1025)
    assert [bucket_dim(d) for d in dims] == [jax_bucket_dim(d) for d in dims] == [1, 2, 4, 4, 8, 16, 32, 1024, 2048]


def test_pad_unpad_roundtrip():
    (_, _), (ta, _) = rand_pair(7)
    padded = tbatch.pad_block_sparse(ta)
    padded.check()
    assert all(bucket_dim(d) == d for ix in padded.indices for _, d in ix.sectors)
    back = tbatch.unpad_block_sparse(padded, ta.indices)
    assert back.indices == ta.indices
    assert_blocks_close(back, ta, 0.0)


def test_dims_differing_within_a_bucket_pad_equal():
    """The compile-once property: structures that differ only by a sector
    dim inside one bucket are identical once padded."""
    ix13 = Index((((0,), 13), ((2,), 5)), OUT)
    ix14 = Index((((0,), 14), ((2,), 6)), OUT)
    assert tbatch.pad_index(ix13) == tbatch.pad_index(ix14)


@pytest.mark.parametrize("seed", [9, 21])
def test_padded_contraction_equals_padding_of_contraction(seed):
    """A contraction of padded operands, unpadded, equals the reference's
    contraction (<=1e-13), and is exactly zero in the padding."""
    (ja, jb), (ta, tb) = rand_pair(seed)
    eng = ContractionEngine("batched", PlanCache())
    plain = eng(ta, tb, AX)
    padded = eng(tbatch.pad_block_sparse(ta), tbatch.pad_block_sparse(tb), AX)
    assert_blocks_close(tbatch.unpad_block_sparse(padded, plain.indices), jbs.contract(ja, jb, AX), 1e-13)
    for k, blk in padded.blocks.items():
        r, c = (plain.indices[i].sector_dim(k[i]) for i in range(2))
        assert not blk[r:, :].any() and not blk[:, c:].any()


def _sweeping_engine(jit_matvec=True):
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.core.mps import neel_states, product_state_mps
    from repro_torch.core.sweep import DMRGEngine

    sp, terms = tmodels.spin_half_space(), tmodels.heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    mpo = compress_mpo(build_mpo(sp, terms, 6, device="cpu"), cutoff=1e-13)
    mps = product_state_mps(sp, neel_states(sp, 6), device="cpu")
    return DMRGEngine(mps, mpo, algo="batched", jit_matvec=jit_matvec, davidson_iters=2, device="cpu")


def test_captures_stop_growing_after_warmup():
    """The graphed matvec and env updates capture while the structure still
    changes and then replay: at steady state a sweep captures nothing."""
    eng = _sweeping_engine()
    captures = [eng.sweep(max_bond=8).graphs["graph_captures"] for _ in range(8)]
    assert captures[0] > 0 and captures[-2:] == [0, 0], captures
    s = eng.sweep(max_bond=8)
    assert s.graphs["graph_captures"] == 0
    # per pair optimization at least one matvec and one env update
    assert s.graphs["graph_replays"] >= 2 * (6 - 1) * 2


def _middle_operands(j=2):
    """The engine of a swept 3x2 run and the padded (A, W_j, W_{j+1}, B,
    theta) of its pair (j, j+1)."""
    eng = _sweeping_engine()
    eng.sweep(max_bond=8)
    engine = eng.contract_fn
    T, A = eng.mps.tensors, eng.left_envs[0]
    for i in range(j):  # the left environments are stale after a sweep
        A = engine.env_update_left(A, T[i], eng.mpo[i])
    A, B = tbatch.pad_block_sparse(A), tbatch.pad_block_sparse(eng.right_envs[j + 1])
    Wj, Wj1 = eng._padded_mpo(j), eng._padded_mpo(j + 1)
    return engine, (A, Wj, Wj1, B, tbatch.pad_block_sparse(engine(T[j], T[j + 1], ((2,), (0,)))))


def test_graphed_matvec_equals_eager_and_reads_fresh_inputs():
    """Through the graph cache (staged buffers, copied outputs) the matvec
    equals the eager one on every call, for alternating inputs."""
    engine, (A, Wj, Wj1, B, x1) = _middle_operands()
    g = torch.Generator().manual_seed(0)
    x2 = tbs.BlockSparseTensor(x1.indices, {k: torch.randn(b.shape, generator=g, dtype=b.dtype)
                                            for k, b in x1.blocks.items()}, x1.charge)
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    for x in (x1, x2, x1, x2, x1):
        assert_blocks_close(mv(x), engine.two_site_matvec(A, Wj, Wj1, B, x), 1e-13)


def test_graph_entry_keeps_the_plans_it_reads():
    """A graphed matvec's entry holds its four step plans (and with them the
    device tables a graph reads by address): dropping the plan cache frees
    none of them, and later calls replay with them, equal to the eager
    matvec and capturing nothing."""
    import gc
    import weakref

    from repro_torch.dist.graphs import GraphCache

    engine, (A, Wj, Wj1, B, x) = _middle_operands()
    engine.cache, engine.graphs = PlanCache(), GraphCache()
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    want = mv(x)
    held = [weakref.ref(p) for p in engine.cache._plans.values()]
    assert len(held) == 4
    engine.cache = PlanCache(maxsize=1)
    gc.collect()
    assert all(r() is not None for r in held)
    captures = engine.graphs.captures
    assert_blocks_close(mv(x), want, 1e-13)
    assert engine.graphs.captures == captures and len(engine.cache) == 0
    assert_blocks_close(want, engine.two_site_matvec(A, Wj, Wj1, B, x), 1e-13)


def test_graph_cache_is_bounded_and_counts():
    from repro_torch.dist.graphs import GraphCache

    cache = GraphCache()
    cache.max_graphs = 2
    x = torch.arange(6, dtype=torch.float64)
    for key in ("a", "b", "c", "a"):
        out, meta = cache.run(key, lambda _f, live, _k: [live[0] * 2], lambda: ([(6,)], key, None), [x])
        assert torch.equal(out[0], 2 * x) and meta == key
    st = cache.stats()
    assert (st["graph_captures"], st["graph_replays"], st["graphs"], st["evictions"]) == (4, 4, 2, 2)
    with pytest.raises(RuntimeError, match="prepared"):
        cache.run("d", lambda _f, live, _k: [live[0][:3]], lambda: ([(6,)], None, None), [x])


def test_graph_cache_buffer_growth_and_fixed_token():
    """A larger structure grows the static buffers and drops no graph: the
    smaller one keeps its own buffers, replays without a new capture and
    still reads its own inputs.  Fixed inputs are staged again only when
    another token's were staged into its buffer between."""
    from repro_torch.dist.graphs import GraphCache

    cache = GraphCache()
    small, big = torch.arange(4.0, dtype=torch.float64), torch.arange(50.0, dtype=torch.float64)
    w1, w2 = torch.full((3,), 2.0, dtype=torch.float64), torch.full((3,), 5.0, dtype=torch.float64)
    t1, t2 = object(), object()

    def body(fixed, live, _keep):
        return [live[0] * fixed[0].sum()]

    def run(key, x, w, token):
        return cache.run(key, body, lambda: ([tuple(x.shape)], None, None), [x], [w], fixed_token=token)[0][0]

    assert torch.equal(run("s", small, w1, t1), small * 6)
    assert torch.equal(run("b", big, w2, t2), big * 15)
    assert cache.stats()["buffer_growths"] >= 1
    assert torch.equal(run("s", small, w1, t1), small * 6)  # its own buffer still holds t1's
    assert torch.equal(run("s", small + 1, w2, t1), (small + 1) * 6)  # same token: fixed not restaged
    assert torch.equal(run("s", small, w2, t2), small * 15)
    assert cache.stats()["graph_captures"] == 2


N, BONDS = 8, (16,)
RUN_KW = dict(algo="batched", jit_matvec=True)


@pytest.fixture(scope="module")
def ref():
    return jax_reference(*jmodels.heisenberg_chain_system(N), N, BONDS, **RUN_KW)


def test_batched_jit_chain_matches_jax_and_ed(ref):
    """run_dmrg(algo="batched", jit_matvec=True) with the reference's
    defaults: <1e-10 from the reference's same call, <=1e-7 from ED (the
    reference's own run is 3.7e-8 from it at m=16, two sweeps)."""
    res = check_slice(ref, *tmodels.heisenberg_chain_system(N), N, BONDS, ed_tol=1e-7, **RUN_KW)
    assert sum(s.graphs["graph_replays"] for s in res.sweep_stats) > 0
