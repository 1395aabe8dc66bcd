"""The port's CUDA kernel on the card, held against its plain version.

Every test here is marked ``cuda`` and skips where no card is present.  The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.block_gemm.ops import block_sparse_matmul  # noqa: E402
from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref  # noqa: E402

pytestmark = pytest.mark.cuda

# relative tolerance per dtype: f64 and f32 differ from the plain version
# only in summation order; bf16 rounds the f32 sum once, as the plain does
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,BM,BK,BN,out_idx,num_out", [
    (7, 37, 200, 45, [0, 0, 1, 1, 1, 3, 3], 4),   # k-tiling, ragged, block 2 empty
    (5, 130, 33, 70, [0, 1, 1, 2, 2], 4),         # several m/n tiles, block 3 empty
    (1, 1, 1, 1, [0], 1),
])
def test_kernel_matches_plain(card, dtype, P, BM, BK, BN, out_idx, num_out):
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(rng.standard_normal((P, BM, BK))).to(card, dtype)
    rhs = torch.from_numpy(rng.standard_normal((P, BK, BN))).to(card, dtype)
    idx = np.array(out_idx, np.int64)
    before = kernels.LAUNCHES["block_gemm"]
    got = block_sparse_matmul(lhs, rhs, idx, num_out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["block_gemm"] == before + 1
    want = block_sparse_matmul_ref(lhs, rhs, idx, num_out)
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= TOL[dtype] * scale
    for o in sorted(set(range(num_out)) - set(out_idx)):
        assert not got[o].any()


def test_kernel_skips_beyond_extents(card):
    """Per-pair extents: the kernel reads only each pair's true block, and
    matches the plain version on the zero-padded operands to 1e-12."""
    rng = np.random.default_rng(1)
    ext = np.array([[50, 40, 30], [10, 40, 30], [50, 5, 30], [50, 40, 7], [1, 1, 1], [33, 17, 29]], np.int32)
    lhs = torch.zeros((6, 50, 40), dtype=torch.float64)
    rhs = torch.zeros((6, 40, 30), dtype=torch.float64)
    for p, (m, k, n) in enumerate(ext):
        lhs[p, :m, :k] = torch.from_numpy(rng.standard_normal((m, k)))
        rhs[p, :k, :n] = torch.from_numpy(rng.standard_normal((k, n)))
    lhs, rhs = lhs.to(card), rhs.to(card)
    idx = np.array([0, 0, 0, 1, 2, 2])
    got = block_sparse_matmul(lhs, rhs, idx, 3, extents=torch.from_numpy(ext).to(card))
    want = block_sparse_matmul_ref(lhs, rhs, idx, 3)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def test_wrapper_raises_instead_of_falling_back(card):
    """On the card the wrapper launches the kernel or raises."""
    lhs = torch.zeros((2, 3, 4), dtype=torch.float64, device=card)
    rhs = torch.zeros((2, 4, 5), dtype=torch.float64, device=card)
    with pytest.raises(TypeError):
        block_sparse_matmul(lhs.to(torch.int64), rhs.to(torch.int64), np.zeros(2), 1)
    with pytest.raises(ValueError):
        block_sparse_matmul(lhs.transpose(1, 2).contiguous().transpose(1, 2), rhs, np.zeros(2), 1)
    with pytest.raises(ValueError):
        block_sparse_matmul(lhs, rhs, np.array([1, 0]), 2)


def test_slice_on_card_matches_ed(card):
    """run_dmrg(algo="csr") on the card goes through the kernel and gets
    the 3x2 open J1-J2 ground energy to 1e-8."""
    from repro_torch.core import run_dmrg
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.siteops import spin_half_space

    sp, terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    before = kernels.LAUNCHES["block_gemm"]
    res = run_dmrg(sp, terms, 6, bond_schedule=(8,), sweeps_per_bond=2, davidson_iters=4, algo="csr")
    assert kernels.LAUNCHES["block_gemm"] > before
    assert abs(res.energy - ground_energy(sp, terms, 6, charge=(0,))) <= 1e-8
