"""The port's stacked multi-problem pieces (``repro_torch/serve/stacked.py``
and the stacked paths of ``dist/batch.py``, ``dist/envcore.py`` and
``serve/multicore.py``) held against the reference's ``repro.serve`` on the
same seeded numpy blocks, and against the port's own per-problem paths.

Every comparison is f64: with the reference <=1e-12, with the port's
per-problem execution <=1e-13 (the folded bucket runs the same products).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import stacked as jst  # noqa: E402
from repro.serve import svd_split_multi as jax_svd_split_multi  # noqa: E402
from repro.tensor import blocksparse as jbs  # noqa: E402
from repro_torch.dist import batch as tbatch  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402
from repro_torch.dist.plan import PlanCache  # noqa: E402
from repro_torch.kernels.block_gemm.ops import segments  # noqa: E402
from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref  # noqa: E402
from repro_torch.kernels.block_gemm.work import work_list  # noqa: E402
from repro_torch.serve import stacked as tst  # noqa: E402
from repro_torch.serve import svd_split_multi  # noqa: E402
from repro_torch.tensor import blocksparse as tbs  # noqa: E402

from _torch_helpers import IN, OUT, S1, S2, SP, make_both, rand_sectors, specs, work_emulate  # noqa: E402

B = 3


def stacked_both(seed, index_specs, charge=(0,), batch=B):
    """B random problems of one structure, stacked in each package."""
    pairs = [make_both(1000 * seed + b, index_specs, charge) for b in range(batch)]
    return jst.stack_tensors([j for j, _ in pairs]), tst.stack_tensors([t for _, t in pairs]), pairs


def assert_stacked_close(got, want, tol):
    """Same structure, every [B, ...] block within ``tol`` (max abs)."""
    assert specs(got.indices) == specs(want.indices) and got.charge == want.charge
    assert set(got.blocks) == set(want.blocks)
    for k in want.blocks:
        g, w = np.asarray(got.blocks[k]), np.asarray(want.blocks[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.max(np.abs(g - w), initial=0.0) <= tol, k


VEC = [(S1, IN, "l"), (SP, OUT, "s"), (S2, OUT, "r")]


@pytest.mark.parametrize("op", ["binner", "bnorm", "bscale", "bselect", "blincomb", "stack_roundtrip"])
def test_stacked_algebra_matches_reference(op):
    """Per-problem scalars and their use, against ``repro.serve.stacked``."""
    ja, ta, pairs = stacked_both(1, VEC)
    jb, tb, _ = stacked_both(2, VEC)
    c = np.array([0.5, -2.0, 3.25])
    if op == "binner":
        np.testing.assert_allclose(tst.binner(ta, tb).numpy(), np.asarray(jst.binner(ja, jb)), rtol=0, atol=1e-12)
    elif op == "bnorm":
        np.testing.assert_allclose(tst.bnorm(ta).numpy(), np.asarray(jst.bnorm(ja)), rtol=0, atol=1e-12)
    elif op == "bscale":
        assert_stacked_close(tst.bscale(ta, c), jst.bscale(ja, c), 1e-12)
        assert_stacked_close(tst.bscale(ta, torch.from_numpy(c)), jst.bscale(ja, c), 1e-12)
    elif op == "bselect":
        mask = np.array([True, False, True])
        assert_stacked_close(tst.bselect(mask, ta, tb), jst.bselect(mask, ja, jb), 0.0)
    elif op == "blincomb":
        coeffs = np.stack([c, -c[::-1]], 1)
        assert_stacked_close(tst.blincomb([ta, tb], coeffs), jst.blincomb([ja, jb], coeffs), 1e-12)
    else:
        for b, (_, t) in enumerate(pairs):
            one = tst.unstack_tensor(ta, b)
            assert all(torch.equal(one.blocks[k], t.blocks[k]) for k in t.blocks)
        bc = tst.broadcast_tensor(pairs[0][1], 4)
        assert tst.batch_size(bc) == 4
        assert_stacked_close(bc, jst.broadcast_tensor(pairs[0][0], 4), 0.0)
        with pytest.raises(ValueError, match="block keys"):
            tst.stack_tensors([ta, tbs.BlockSparseTensor(ta.indices, {}, ta.charge)])


def _pair_structure(seed):
    """Index specs of A [a, s] and B [s*, b] with at least one block pair."""
    rng = np.random.default_rng(seed)
    shared = rand_sectors(rng, 1, max_sectors=4)

    def subset(sign):
        keep = [sec for sec in shared if rng.random() < 0.7] or [shared[0]]
        return tuple((tuple(sign * c for c in q), int(rng.integers(1, 5))) for q, _ in keep)

    return [(subset(-1), OUT, "a"), (shared, OUT, "s")], [(shared, IN, "s"), (subset(1), OUT, "b")]


def _cases():
    cases = []
    for seed in range(4):
        a_specs, b_specs = _pair_structure(seed)
        cases.append((seed, a_specs, b_specs, ((1,), (0,))))
    rng = np.random.default_rng(50)
    s1, s2, s3 = (rand_sectors(rng, max_dim=5) for _ in range(3))
    cases.append((50, [(s1, OUT, "1"), (s2, OUT, "2"), (s3, OUT, "3")],
                  [(s2, IN, "2"), (s3, IN, "3"), (s1, OUT, "1")], ((1, 2), (0, 1))))
    return cases


@pytest.mark.parametrize("seed,a_specs,b_specs,axes", _cases(), ids=lambda v: str(v) if isinstance(v, int) else "")
def test_folded_buckets_match_per_problem_and_reference(seed, a_specs, b_specs, axes):
    """One stacked batched contraction (each bucket one block GEMM over B*P
    folded pairs, here its plain version) equals the per-problem
    ``execute_batched`` runs (<=1e-13) and the reference's vmapped
    ``StackedOps.contract`` (<=1e-12)."""
    ja, ta, pa = stacked_both(seed, a_specs)
    jb, tb, pb = stacked_both(seed + 500, b_specs)
    engine = ContractionEngine("batched", PlanCache())
    got = engine(ta, tb, axes)
    if not got.blocks:
        pytest.skip("no block pair")
    for b in range(B):
        one = engine(pa[b][1], pb[b][1], axes)
        assert set(one.blocks) == set(got.blocks)
        for k, blk in one.blocks.items():
            assert (got.blocks[k][b] - blk).abs().max().item() <= 1e-13
    assert_stacked_close(got, jst.StackedOps().contract(ja, jb, axes), 1e-12)
    # and the list pieces (the env core's), a batched matmul per pair
    plan = engine.cache.get(ta, tb, axes)
    pieces = tbatch.execute_pairs(plan, ta.blocks, tb.blocks)
    for k, blk in pieces.items():
        assert (blk - got.blocks[k]).abs().max().item() <= 1e-13


def test_folded_work_list_covers_the_batch():
    """A bucket's folded work list has the shape the wrapper demands, (B*P,
    B*O, m, k, n), is built once per batch size, and the kernel's two
    passes, emulated over it on the folded operands, give every problem's
    per-problem result (<=1e-13)."""
    a_specs, b_specs = _pair_structure(3)
    _, ta, pa = stacked_both(3, a_specs, batch=4)
    _, tb, pb = stacked_both(503, b_specs, batch=4)
    plan = PlanCache().get(ta, tb, ((1,), (0,)))
    mats_a = tbatch.matricize_lhs(ta, plan.keep_a, plan.ax_a)
    mats_b = tbatch.matricize_rhs(tb, plan.keep_b, plan.ax_b)
    for bucket in plan.batched.buckets:
        P, O = len(bucket.oi), len(bucket.out_keys)
        work = bucket.folded_work(4)
        assert work is bucket.folded_work(4) and bucket.folded_work(1) is bucket.work
        assert work.shape == (4 * P, 4 * O, bucket.m, bucket.k, bucket.n)
        oi = bucket.folded_oi(4)
        assert list(oi) == sorted(oi) and list(oi[:P]) == list(bucket.oi)
        want_wl = work_list(segments(oi, 4 * O), None, bucket.m, bucket.k, bucket.n)
        np.testing.assert_array_equal(work.items, want_wl.items)
        lhs, rhs = tbatch.bucket_operands(bucket, mats_a, mats_b)
        ext = np.tile(np.array([bucket.m, bucket.k, bucket.n]), (4 * P, 1))
        got = work_emulate(lhs, rhs, ext, work, 4 * O).view(4, O, bucket.m, bucket.n)
        for b in range(4):
            one_a = tbatch.matricize_lhs(pa[b][1], plan.keep_a, plan.ax_a)
            one_b = tbatch.matricize_rhs(pb[b][1], plan.keep_b, plan.ax_b)
            l1, r1 = tbatch.bucket_operands(bucket, one_a, one_b)
            want = block_sparse_matmul_ref(l1, r1, bucket.oi, O)
            assert (got[b] - want).abs().max().item() <= 1e-13


def test_pad_unpad_stacked_roundtrip():
    """Stacked pads round every sector dim to a power of two and leave the
    problem axis alone, equal to the reference's ``pad_stacked``."""
    ja, ta, _ = stacked_both(7, VEC)
    padded = tst.pad_stacked(ta)
    assert_stacked_close(padded, jst.pad_stacked(ja), 0.0)
    assert all(b.shape[0] == B for b in padded.blocks.values())
    back = tst.unpad_stacked(padded, ta.indices)
    assert_stacked_close(back, ta, 0.0)
    assert_stacked_close(back, jst.unpad_stacked(jst.pad_stacked(ja), ja.indices), 0.0)


def _mpo_site():
    """The middle site of the reference's compressed 6-site Heisenberg MPO
    (h=0.3), in both packages."""
    from _torch_helpers import to_arrays
    from repro.core.models import heisenberg_chain_system
    from repro.core.mpo import build_mpo, compress_mpo
    from repro_torch.convert import bst_from_arrays

    space, terms = heisenberg_chain_system(6, h=0.3)
    w = compress_mpo(build_mpo(space, terms, 6), cutoff=1e-13)[2]
    return w, bst_from_arrays(*to_arrays(w), device="cpu")


@pytest.mark.parametrize("side", ["left", "right"])
def test_stacked_env_update_matches_reference_and_singles(side):
    """The fused environment update on stacked operands equals the
    reference's vmapped one (<=1e-12) and the port's per-problem updates
    (<=1e-13)."""
    jw, tw = _mpo_site()
    L, R = (((-1,), 2), ((1,), 3)), S2
    site = [(L, IN, "l"), (SP, OUT, "s"), (R, OUT, "r")]
    if side == "left":
        env = [(L, IN, "i"), (jw.indices[0].sectors, OUT, "k"), (L, OUT, "l")]
    else:
        env = [(R, OUT, "i"), (jw.indices[3].sectors, IN, "k"), (R, IN, "l")]
    je, te, pe = stacked_both(60, env)
    jt, tt, pt = stacked_both(61, site)
    jW, tW = jst.broadcast_tensor(jw, B), tst.broadcast_tensor(tw, B)
    ops = tst.StackedOps(ContractionEngine("batched"))
    got = ops.env_update(side, te, tt, tW)
    assert ops.retraces == 1  # one graph key (here an eager first run)
    assert_stacked_close(got, jst.StackedOps().env_update(side, je, jt, jW), 1e-12)
    single = ContractionEngine("batched")
    update = single.env_update_left if side == "left" else single.env_update_right
    for b in range(B):
        one = update(pe[b][1], pt[b][1], tw)
        for k, blk in one.blocks.items():
            assert (got.blocks[k][b] - blk).abs().max().item() <= 1e-13
    ops.env_update(side, te, tt, tW)
    assert ops.retraces == 1  # the same (structure, B) key: no new one


def test_svd_split_multi_matches_reference_and_masks():
    """Per problem: the singular values and kept sectors of the reference's
    ``svd_split_multi`` (<=1e-12), its truncation errors, U·V equal to the
    reference's (gauge-free, <=1e-12), and exact zeros beyond each
    problem's own retained count."""
    theta_specs = [(S2, IN, "l"), (SP, OUT, "s1"), (SP, OUT, "s2"), (S2, OUT, "r")]
    jt, tt, _ = stacked_both(70, theta_specs, batch=4)
    ju, jv, jsv, jerr = jax_svd_split_multi(jt, 2, max_bond=6, cutoff=1e-12)
    tu, tv, tsv, terr = svd_split_multi(tt, 2, max_bond=6, cutoff=1e-12, ops=tst.StackedOps(ContractionEngine("batched")))
    np.testing.assert_allclose(terr, np.asarray(jerr), rtol=0, atol=1e-12)
    assert set(tsv) == set(jsv)
    for q in jsv:
        np.testing.assert_allclose(tsv[q].numpy(), np.asarray(jsv[q]), rtol=0, atol=1e-12)
    assert specs(tu.indices) == specs(ju.indices) and specs(tv.indices) == specs(jv.indices)
    got = ContractionEngine("batched", PlanCache())(tu, tv, ((2,), (0,)))
    assert_stacked_close(got, jst.StackedOps().contract(ju, jv, ((2,), (0,))), 1e-12)
    kept = {q: (np.asarray(v) > 0).sum(axis=1) for q, v in jsv.items()}
    assert any(len(set(n.tolist())) > 1 for n in kept.values())  # the problems keep different counts
    for q, v in tsv.items():
        for b in range(4):
            assert not v[b, kept[q][b]:].any()
