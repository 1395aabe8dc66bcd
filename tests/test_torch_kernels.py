"""The port's block GEMM wrapper and plain version held against the JAX kernel.

The JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does; the same numpy operands go into both.  On
the CPU the port's wrapper takes its plain PyTorch version: the CUDA kernel
itself is held against that version on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.block_gemm.ops import block_sparse_matmul as jax_block_gemm  # noqa: E402
from repro.tensor import blocksparse as jbs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402
from repro_torch.kernels.block_gemm.ops import block_sparse_matmul, segments  # noqa: E402
from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref  # noqa: E402
from repro_torch.kernels.block_gemm.work import WRITTEN, ZEROS, route, work_list  # noqa: E402

from _torch_helpers import CASES, make_both, work_emulate, work_walk  # noqa: E402

# (P, BM, BK, BN, out_idx, num_out): output block 2 has no pair; BK=200
# spans two of the JAX kernel's 128-deep k-tiles; ragged M/N edges
GEMM_CASES = {
    "uncovered_output": (5, 8, 16, 16, [0, 0, 1, 3, 3], 4),
    "k_tiling": (3, 16, 200, 24, [0, 0, 1], 2),
    "ragged": (4, 13, 7, 19, [0, 1, 1, 2], 3),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_ref_matches_jax_kernel(case, dtype, tol):
    """Port plain version (and the wrapper, which takes it on the CPU) vs
    the JAX Pallas kernel in interpret mode: within 1e-5 in f32, 1e-12 in
    f64; an output block with no pair is exactly zero on both."""
    P, BM, BK, BN, oi, O = GEMM_CASES[case]
    rng = np.random.default_rng(7)
    lhs = rng.standard_normal((P, BM, BK)).astype(dtype)
    rhs = rng.standard_normal((P, BK, BN)).astype(dtype)
    idx = np.array(oi, np.int32)
    want = np.asarray(jax_block_gemm(
        jnp.asarray(lhs), jnp.asarray(rhs), idx, O, bm=16, bn=128, bk=128, interpret=True
    ))
    before = dict(kernels.LAUNCHES)
    for got in (
        block_sparse_matmul_ref(torch.from_numpy(lhs), torch.from_numpy(rhs), idx, O),
        block_sparse_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs), idx, O),
    ):
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (O, BM, BN)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
        for o in sorted(set(range(O)) - set(oi)):
            assert not got[o].any()
    assert kernels.LAUNCHES == before  # CPU calls are not kernel launches


def test_ref_bfloat16_accumulates_in_float32():
    """bf16 operands: products summed in f32 and rounded once, within the
    JAX kernel's bf16 tolerance (5e-2) of an f64 product of the same
    (bf16-rounded) values."""
    rng = np.random.default_rng(3)
    lhs = torch.from_numpy(rng.standard_normal((4, 9, 40))).to(torch.bfloat16)
    rhs = torch.from_numpy(rng.standard_normal((4, 40, 11))).to(torch.bfloat16)
    idx = np.array([0, 0, 0, 1])
    got = block_sparse_matmul_ref(lhs, rhs, idx, 2)
    assert got.dtype == torch.bfloat16
    exact = block_sparse_matmul_ref(lhs.double(), rhs.double(), idx, 2)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), rtol=5e-2, atol=5e-2)


def test_segments():
    """seg[o]:seg[o+1] are the pairs of output block o, empty where it has
    none; unsorted or out-of-range ids are refused."""
    np.testing.assert_array_equal(segments(np.array([0, 0, 2, 2, 2]), 4), [0, 2, 2, 5, 5])
    np.testing.assert_array_equal(segments(np.array([], np.int64), 2), [0, 0, 0])
    for bad in ([1, 0], [0, 3], [-1, 0]):
        with pytest.raises(ValueError):
            segments(np.array(bad), 3)


def test_wrapper_rejects_operands_that_do_not_chain():
    lhs = torch.zeros((2, 3, 4), dtype=torch.float64)
    for rhs in (torch.zeros((2, 5, 6), dtype=torch.float64), torch.zeros((3, 4, 6), dtype=torch.float64)):
        with pytest.raises(ValueError, match="chain"):
            block_sparse_matmul(lhs, rhs, np.zeros(2, np.int64), 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_layout_feeds_the_kernel_what_it_assumes(case):
    """The csr plan's packed operands are what the CUDA kernel assumes: pairs
    sorted by output block, the kernel's work list built for their
    segments and shape, and every packed entry
    beyond a pair's ``extents`` zero (the kernel skips those entries); the
    packed product equals the JAX ``contract`` block for block to 1e-12."""
    a_specs, qa, b_specs, qb, axes = CASES[case]
    ja, ta = make_both(11, a_specs, qa)
    jb, tb = make_both(12, b_specs, qb)
    engine = ContractionEngine("csr")
    plan = engine.cache.get(ta, tb, axes)
    lhs, rhs, oi, work, ext = engine.pack_csr(plan, ta, tb)
    L = plan.csr
    assert np.all(np.diff(oi) >= 0)
    np.testing.assert_array_equal(L.seg, segments(oi, len(L.out_keys)))
    assert work is L.work and work.shape == (len(oi), len(L.out_keys), L.bm, L.bk, L.bn)
    for p, (m, k, n) in enumerate(ext.tolist()):
        assert m <= L.bm and k <= L.bk and n <= L.bn
        assert not lhs[p, m:, :].any() and not lhs[p, :, k:].any()
        assert not rhs[p, k:, :].any() and not rhs[p, :, n:].any()
    assert plan.flops_list == pytest.approx(float(np.sum(2.0 * np.prod(ext.numpy().astype(float), axis=1))))
    want = jbs.contract(ja, jb, axes)
    out = block_sparse_matmul(lhs, rhs, oi, len(L.out_keys))
    for o, (kc, (r, c)) in enumerate(zip(L.out_keys, L.out_rc)):
        np.testing.assert_allclose(
            out[o, :r, :c].reshape(plan.out_block_shape(kc)).numpy(),
            np.asarray(want.blocks[kc]), rtol=0, atol=1e-12,
        )
        assert not out[o, r:, :].any() and not out[o, :, c:].any()


# ------------------------------------------------- the kernel's work list
# (P, BM, BK, BN, out_idx, num_out, extents or None).  Long segments that the
# planner cuts, empty output blocks, ragged and per-pair extents (a pair
# with no depth), and the skinny route (BK, BN <= 16) with a cut segment.
WORK_CASES = {
    "long_segment": (5, 70, 300, 40, [0, 0, 0, 0, 2], 3, None),
    "extents": (6, 130, 40, 70, [0, 0, 0, 1, 3, 3], 4,
                [[130, 40, 70], [10, 40, 70], [130, 5, 70], [130, 40, 7], [1, 0, 1], [33, 17, 69]]),
    "k_split_extents": (4, 64, 600, 64, [1, 1, 1, 1], 2, [[64, 600, 64], [20, 333, 64], [64, 1, 3], [64, 599, 64]]),
    "skinny": (30, 600, 6, 5, [0] * 20 + [2] * 10, 3, "random"),
    "skinny_1x1": (3, 5, 1, 1, [0, 2, 2], 4, None),
}


def _work_case(name, rng):
    P, BM, BK, BN, oi, O, ext = WORK_CASES[name]
    if ext == "random":
        ext = np.stack([rng.integers(1, BM + 1, P), rng.integers(0, BK + 1, P), rng.integers(1, BN + 1, P)], 1)
    ext = np.array(ext if ext is not None else [[BM, BK, BN]] * P, np.int64)
    lhs = torch.zeros((P, BM, BK), dtype=torch.float64)
    rhs = torch.zeros((P, BK, BN), dtype=torch.float64)
    for p, (m, k, n) in enumerate(ext):
        lhs[p, :m, :k] = torch.from_numpy(rng.standard_normal((m, k)))
        rhs[p, :k, :n] = torch.from_numpy(rng.standard_normal((k, n)))
    seg = segments(np.array(oi), O)
    return lhs, rhs, np.array(oi), O, ext, work_list(seg, ext.astype(np.int32), BM, BK, BN)


@pytest.mark.parametrize("case", sorted(WORK_CASES))
def test_work_list_covers_every_unit_once(case):
    """Every (pair, k-tile) of an output block is in exactly one work item
    of each tile that the block's largest extents reach; every tile of the
    padded output is written once: by its only item, by the second pass
    over its items' slots, or as zeros where no pair reaches."""
    lhs, rhs, oi, O, ext, work = _work_case(case, np.random.default_rng(5))
    P, BM, BK, BN = *lhs.shape, rhs.shape[2]
    assert work.route == route(BM, BK, BN) == ("skinny" if case.startswith("skinny") else "tiled")
    seg = segments(oi, O)
    mt_all, nt_all = -(-BM // work.tm), -(-BN // work.tn)
    want = []
    for o in range(O):
        pairs = [p for p in range(seg[o], seg[o + 1]) if ext[p][1] > 0]
        if not pairs:
            continue
        rows, cols = max(ext[p][0] for p in range(seg[o], seg[o + 1])), max(ext[p][2] for p in range(seg[o], seg[o + 1]))
        for mt in range(-(-rows // work.tm)):
            for nt in range(-(-cols // work.tn)):
                tile = (o * mt_all + mt) * nt_all + nt
                want += [(tile, p, kt) for p in pairs for kt in range(-(-ext[p][1] // work.tk))]
    got = [u for item in work.items for u in work_walk(item, ext, work)]
    assert sorted(got) == sorted(want) and len(set(got)) == len(got)
    dests = {}
    for item in work.items:
        dests.setdefault(int(item[0]), []).append(int(item[4]))
    assert len(work.tile_fix) == O * mt_all * nt_all
    slots = []
    for tile, state in enumerate(work.tile_fix.tolist()):
        if state == ZEROS:
            assert tile not in dests
        elif state == WRITTEN:
            assert dests[tile] == [-1]
        else:
            first, count = (int(x) for x in work.fix[state])
            assert count >= 2 and sorted(dests[tile]) == list(range(first, first + count))
            slots += dests[tile]
    assert sorted(slots) == list(range(work.n_slots))
    if case in ("long_segment", "skinny"):
        assert work.n_slots > 0  # the planner did cut a segment


@pytest.mark.parametrize("case", sorted(WORK_CASES))
def test_two_pass_emulation_matches_plain(case):
    """The kernel's split and second pass, emulated in torch over the work
    list, equal the plain version to 1e-13 of the largest |value| in f64,
    with every element of the padded output written and empty blocks zero."""
    lhs, rhs, oi, O, ext, work = _work_case(case, np.random.default_rng(6))
    got = work_emulate(lhs, rhs, ext, work, O)
    want = block_sparse_matmul_ref(lhs, rhs, oi, O)
    assert not got.isnan().any()
    assert (got - want).abs().max().item() <= 1e-13 * max(want.abs().max().item(), 1.0)
    for o in sorted(set(range(O)) - set(oi.tolist())):
        assert not got[o].any()
