"""The port's CUDA kernels on the card, held against their plain versions.

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


# ------------------------------------------------ flash attention, rwkv6 scan
# Flash attention per output row, max over rows of ||got - want|| / ||want||
# (chip_smoke.py's metric and limits): 2e-5 in float32 (the reference's
# tolerance; the order of the sums differs) and 2e-2 in bfloat16, above the
# kernel's own roundings of p and of its output (2^-9 each) and below a
# dropped key tile or a tile missing from the softmax denominator
# (chip_smoke.py phase 9).  The scan: the reference's 2e-4 (chunked against
# stepwise sums), relative to the largest |value|.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = 2e-4


def _rel_err(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30)).item()


def _row_rel_err(got, want):
    g, w = got.reshape(-1, got.shape[-1]).double(), want.reshape(-1, want.shape[-1]).double()
    return ((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-300)).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 1, 4, 4, 64),       # one token
    (2, 37, 8, 2, 48),      # ragged S, GQA, d=48
    (1, 300, 4, 1, 128),    # ragged over several tiles, one KV head
    (1, 128, 2, 2, 16),
    (1, 70, 2, 1, 40),      # d % 16 != 0: the CUDA-core kernel in bf16 too
])
def test_flash_kernel_matches_plain(card, dtype, b, s, h, hkv, d):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    g = torch.Generator(device=card).manual_seed(s * d)
    q = torch.randn(b, s, h, d, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device=card).to(dtype)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _row_rel_err(got, flash_attention_bshd(q, k, v, use_kernel=False)) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_strictly_causal(card, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn(1, 128, 1, 64, generator=g, device=card).to(dtype) for _ in range(3))
    o1 = flash_attention_bshd(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:] = 99.0
    v2[:, 64:] = -99.0
    o2 = flash_attention_bshd(q, k2, v2)
    assert torch.equal(o1[:, :64], o2[:, :64])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,n,logw_max", [
    (2, 1, 3, 16, 1.0),
    (1, 33, 2, 64, 1.0),      # ragged T over two chunks
    (2, 100, 2, 16, 6.0),     # logw down to -exp(6), past the clip at -60
    (1, 64, 4, 32, 3.0),
])
def test_scan_kernel_matches_plain(card, dtype, b, t, h, n, logw_max):
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    g = torch.Generator(device=card).manual_seed(t * n)
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=card)).to(dtype) for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=card).to(dtype)
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=card) * (logw_max + 8.0) - 8.0)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device=card)
    before = kernels.LAUNCHES["rwkv6_scan"]
    got, s_fin = rwkv6_wkv(r, k, v, logw, u, state=s0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rwkv6_scan"] == before + 1
    want, s_want = rwkv6_wkv(r, k, v, logw, u, state=s0, use_kernel=False)
    assert got.dtype == dtype
    # bf16 inputs: the kernel and the plain version both compute in f32 from
    # the same bf16 values; only the output is rounded to bf16
    tol = SCAN_TOL if dtype == torch.float32 else 1e-2
    assert _rel_err(got, want) <= tol
    assert _rel_err(s_fin, s_want) <= SCAN_TOL


def test_lm_wrappers_raise_instead_of_falling_back(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    q = torch.zeros(1, 8, 2, 16, device=card)
    with pytest.raises(TypeError):
        flash_attention_bshd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention_bshd(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        flash_attention_bshd(torch.zeros(1, 8, 2, 512, device=card), *(torch.zeros(1, 8, 2, 512, device=card),) * 2)
    a = torch.zeros(1, 8, 2, 16, device=card)
    with pytest.raises(TypeError):
        rwkv6_wkv(a, a, a, a.bfloat16(), torch.zeros(2, 16, device=card))
    with pytest.raises(ValueError):
        rwkv6_wkv(*(torch.zeros(1, 8, 2, 48, device=card),) * 4, torch.zeros(2, 48, device=card))


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b"])
def test_lm_decode_on_card_matches_forward(card, arch):
    """At smoke size in float32, cached decode reproduces the kernel path's
    teacher-forced logits to 2e-3 (the reference's bound)."""
    from repro_torch import models
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).smoke()
    params = models.init(cfg, torch.Generator(device=card).manual_seed(0), card)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator(device=card).manual_seed(1), device=card)
    name = "flash_attention" if cfg.family == "dense" else "rwkv6_scan"
    before = kernels.LAUNCHES[name]
    full = models.forward(cfg, params, {"tokens": tok})
    assert kernels.LAUNCHES[name] == before + cfg.n_layers
    cache = models.init_cache(cfg, 2, 40, card)
    dec = []
    for t in range(40):
        logits, cache = models.decode_step(cfg, params, cache, tok[:, t], t)
        dec.append(logits)
    torch.testing.assert_close(torch.stack(dec, 1), full, rtol=2e-3, atol=2e-3)
