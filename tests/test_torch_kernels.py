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

from _torch_helpers import CASES, make_both  # noqa: E402

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
    sorted by output block, ``seg`` their segments, and every packed entry
    beyond a pair's ``extents`` zero (the kernel skips those entries); the
    packed product equals the JAX ``contract`` block for block to 1e-12."""
    a_specs, qa, b_specs, qb, axes = CASES[case]
    ja, ta = make_both(11, a_specs, qa)
    jb, tb = make_both(12, b_specs, qb)
    engine = ContractionEngine("csr")
    plan = engine.cache.get(ta, tb, axes)
    lhs, rhs, oi, seg, ext = engine.pack_csr(plan, ta, tb)
    L = plan.csr
    assert np.all(np.diff(oi) >= 0)
    np.testing.assert_array_equal(seg.numpy(), segments(oi, len(L.out_keys)))
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
