"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``cuda`` and skips where no card is present.  The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math
import threading

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


# (P, BM, BK, BN, out_idx, num_out, extents): one per route and work split --
# a long segment cut into items (second pass), empty blocks, per-pair
# extents with a pair of no depth, odd strides (8-byte copies), the skinny
# route with a cut segment and with 1 x 1 blocks
ROUTE_CASES = {
    "tiled_split": (6, 100, 700, 90, [0, 0, 0, 0, 0, 2], 3, None),
    "tiled_odd": (4, 67, 133, 71, [1, 1, 2, 2], 3, None),
    "tiled_extents": (5, 130, 300, 130, [0, 0, 0, 2, 2], 3,
                      [[130, 300, 130], [17, 299, 130], [130, 0, 130], [64, 64, 65], [1, 1, 1]]),
    "skinny_split": (40, 3000, 6, 5, [0] * 30 + [2] * 10, 3, "random"),
    "skinny_1x1": (3, 5, 1, 1, [0, 2, 2], 4, None),
}


def _route_case(name, card, dtype, seed=0):
    rng = np.random.default_rng(seed)
    P, BM, BK, BN, oi, O, ext = ROUTE_CASES[name]
    if ext == "random":
        ext = np.stack([rng.integers(1, BM + 1, P), rng.integers(0, BK + 1, P), rng.integers(1, BN + 1, P)], 1)
    ext = np.array(ext if ext is not None else [[BM, BK, BN]] * P, np.int32)
    lhs = torch.zeros((P, BM, BK), dtype=torch.float64)
    rhs = torch.zeros((P, BK, BN), dtype=torch.float64)
    for p, (m, k, n) in enumerate(ext):
        lhs[p, :m, :k] = torch.from_numpy(rng.standard_normal((m, k)))
        rhs[p, :k, :n] = torch.from_numpy(rng.standard_normal((k, n)))
    return lhs.to(card, dtype), rhs.to(card, dtype), np.array(oi), O, torch.from_numpy(ext).to(card)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_kernel_routes_match_plain(card, dtype, case):
    """Each route and work split against the plain version; the variant
    counter names the kernel that ran (f64 tiles on the FP64 tensor cores)."""
    from repro_torch.kernels.block_gemm.work import route, variant

    lhs, rhs, oi, O, ext = _route_case(case, card, dtype)
    kind = variant(route(lhs.shape[1], lhs.shape[2], rhs.shape[2]), dtype)
    assert kind == ("skinny" if case.startswith("skinny") else "tiled_dmma" if dtype == torch.float64 else "tiled_fma")
    before = kernels.VARIANT_LAUNCHES["block_gemm"][kind]
    got = block_sparse_matmul(lhs, rhs, oi, O, extents=ext)
    torch.cuda.synchronize()
    assert kernels.VARIANT_LAUNCHES["block_gemm"][kind] == before + 1
    want = block_sparse_matmul_ref(lhs, rhs, oi, O)
    scale = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= TOL[dtype] * scale
    for o in sorted(set(range(O)) - set(oi.tolist())):
        assert not got[o].any()


@pytest.mark.parametrize("case", ["tiled_split", "skinny_split"])
def test_kernel_is_bitwise_reproducible(card, case):
    """No atomics: two f64 launches on the same inputs are bitwise equal."""
    lhs, rhs, oi, O, ext = _route_case(case, card, torch.float64, seed=1)
    assert torch.equal(block_sparse_matmul(lhs, rhs, oi, O, extents=ext),
                       block_sparse_matmul(lhs, rhs, oi, O, extents=ext))


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
    from repro_torch.kernels.block_gemm.work import work_list

    with pytest.raises(ValueError):  # a work list of another shape
        block_sparse_matmul(lhs, rhs, np.zeros(2), 1, work=work_list([0, 2], None, 3, 4, 6))


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


@pytest.mark.parametrize("s", [1, 63, 128, 129, 1000, 2048, 8192])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_flash_wgmma_matches_plain(card, s, d, n_rep):
    """flash_wgmma (bf16, D in {64, 128}) per output row against the plain
    version, B=3 (B=1 at S=8192), 8 query heads."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    b, h = (1 if s == 8192 else 3), 8
    g = torch.Generator(device=card).manual_seed(s * d + n_rep)
    q = torch.randn(b, s, h, d, generator=g, device=card).bfloat16()
    k = torch.randn(b, s, h // n_rep, d, generator=g, device=card).bfloat16()
    v = torch.randn(b, s, h // n_rep, d, generator=g, device=card).bfloat16()
    before = kernels.VARIANT_LAUNCHES["flash_attention"]["flash_wgmma"]
    got = flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    assert kernels.VARIANT_LAUNCHES["flash_attention"]["flash_wgmma"] == before + 1
    assert _row_rel_err(got, flash_attention_bshd(q, k, v, use_kernel=False)) <= FLASH_TOL[torch.bfloat16]


def test_flash_wgmma_is_strictly_causal(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn(2, 384, 4, 128, generator=g, device=card).bfloat16() for _ in range(3))
    o1 = flash_attention_bshd(q, k, v)
    for cut in (200, 256):  # inside a key tile, and at a tile boundary
        k2, v2 = k.clone(), v.clone()
        k2[:, cut:], v2[:, cut:] = 99.0, -99.0
        assert torch.equal(o1[:, :cut], flash_attention_bshd(q, k2, v2)[:, :cut])


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


@pytest.mark.parametrize("t", [1, 45, 128])
def test_scan_kernel_float32_output(card, t):
    """out_dtype=float32 from bf16 inputs (what time_mix asks): the kernel
    writes its f32 sums unrounded, equal to the plain version's to 2e-4."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    g = torch.Generator(device=card).manual_seed(t)
    b, h, n = 2, 3, 64
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=card)).bfloat16() for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=card).bfloat16()
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=card) * 9.0 - 8.0)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    got, _ = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
    want, _ = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32, use_kernel=False)
    assert got.dtype == want.dtype == torch.float32
    assert _rel_err(got, want) <= SCAN_TOL


def _strong_then_weak(b, t, h, n, strong, device):
    """logw = -e^6 for the first ``strong`` steps of every chunk of 32, then
    -1e-3: the pattern whose chunk-wide cumulative sums cancel."""
    lw = torch.full((b, t, h, n), -1e-3, device=device)
    for c0 in range(0, t, 32):
        lw[:, c0:c0 + strong] = -float(np.exp(6.0))
    return lw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("strong", [16, 4])
def test_scan_kernel_strong_then_weak_decay(card, dtype, n, strong):
    """Ragged T = 100 with a carried state: float32 output and state within
    SCAN_TOL of the plain version where the decay is -e^6 for a few steps
    and -1e-3 after (the differences-of-cumulative-sums form reads ~3e-4
    here; tests/test_torch_scan_design.py)."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    g = torch.Generator(device=card).manual_seed(n * strong)
    b, t, h = 2, 100, 3
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=card)).to(dtype) for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=card).to(dtype)
    logw = _strong_then_weak(b, t, h, n, strong, card)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device=card)
    got, s_got = rwkv6_wkv(r, k, v, logw, u, state=s0, out_dtype=torch.float32)
    want, s_want = rwkv6_wkv(r, k, v, logw, u, state=s0, out_dtype=torch.float32, use_kernel=False)
    assert _rel_err(got, want) <= SCAN_TOL
    assert _rel_err(s_got, s_want) <= SCAN_TOL


@pytest.mark.parametrize("b", [1, 4])
def test_scan_kernel_at_the_prefill_shape(card, b):
    """rwkv6_3b's time-mix shape, T = 2048, H = 40, N = 64, bf16 in and
    float32 out, at B = 1 and B = 4 (each picks its own split)."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    g = torch.Generator(device=card).manual_seed(b)
    t, h, n = 2048, 40, 64
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=card)).bfloat16() for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=card).bfloat16()
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=card) * 14.0 - 8.0)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    got, s_got = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
    want, s_want = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32, use_kernel=False)
    assert _rel_err(got, want) <= SCAN_TOL
    assert _rel_err(s_got, s_want) <= SCAN_TOL


def test_scan_kernel_is_bitwise_reproducible(card):
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    g = torch.Generator(device=card).manual_seed(9)
    b, t, h, n = 2, 300, 8, 64
    r, k, v = (torch.randn(b, t, h, n, generator=g, device=card).bfloat16() for _ in range(3))
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=card) * 14.0 - 8.0)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    o1, s1 = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
    o2, s2 = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


@pytest.mark.parametrize("cut", [64, 45])
def test_scan_kernel_carries_state_across_calls(card, cut):
    """Two calls, the second from the first's final state, against one call
    over the whole sequence: bitwise equal when the cut falls on a chunk
    boundary (the same arithmetic), within SCAN_TOL when it does not."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    g = torch.Generator(device=card).manual_seed(cut)
    b, t, h, n = 2, 150, 3, 64
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=card)).bfloat16() for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=card).bfloat16()
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=card) * 14.0 - 8.0)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    whole, s_whole = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
    head = [a[:, :cut].contiguous() for a in (r, k, v, logw)]
    rest = [a[:, cut:].contiguous() for a in (r, k, v, logw)]
    first, s1 = rwkv6_wkv(*head, u, out_dtype=torch.float32)
    second, s2 = rwkv6_wkv(*rest, u, state=s1, out_dtype=torch.float32)
    got = torch.cat([first, second], 1)
    if cut % 32 == 0:
        assert torch.equal(got, whole) and torch.equal(s2, s_whole)
    else:
        assert _rel_err(got, whole) <= SCAN_TOL and _rel_err(s2, s_whole) <= SCAN_TOL


@pytest.mark.parametrize("split", [4, 2, 1])
def test_scan_kernel_every_split_matches_plain_and_counts(card, split):
    """Each state split, forced, against the plain version, counted under its
    own name; and the split the wrapper picks by itself."""
    from repro_torch.kernels.rwkv6_scan import ops

    g = torch.Generator(device=card).manual_seed(split)
    b, t, h, n = 2, 77, 5, 64
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=card)).bfloat16() for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=card).bfloat16()
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=card) * 14.0 - 8.0)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device=card)
    before = dict(kernels.VARIANT_LAUNCHES["rwkv6_scan"])
    got, s_got = ops._launch(r, k, v, logw, u, s0, torch.float32, split)
    torch.cuda.synchronize()
    after = kernels.VARIANT_LAUNCHES["rwkv6_scan"]
    assert {name: after[name] - before[name] for name in after} == {
        name: int(name == f"split{split}") for name in after}
    want, s_want = ops.rwkv6_wkv(r, k, v, logw, u, state=s0, out_dtype=torch.float32, use_kernel=False)
    assert _rel_err(got, want) <= SCAN_TOL and _rel_err(s_got, s_want) <= SCAN_TOL
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    picked = ops.variant(n, b * h, sms)
    before = kernels.VARIANT_LAUNCHES["rwkv6_scan"][picked]
    ops.rwkv6_wkv(r, k, v, logw, u, state=s0)
    assert kernels.VARIANT_LAUNCHES["rwkv6_scan"][picked] == before + 1


def test_scan_wrapper_raises_for_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.rwkv6_scan import ops

    a = torch.zeros(1, 8, 2, 16, device=card)
    u = torch.zeros(2, 16, device=card)
    x = torch.zeros(1 * 8 * 2 * 16 + 1, device=card)[1:].view(1, 8, 2, 16)
    with pytest.raises(ValueError):  # read in 16-byte pieces: 16-byte aligned only
        ops.rwkv6_wkv(x, a, a, a, u)
    with pytest.raises(TypeError):
        ops.rwkv6_wkv(a.half(), a.half(), a.half(), a, u)
    with pytest.raises(TypeError):
        ops.rwkv6_wkv(a, a, a, a, u, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        ops.rwkv6_wkv(a.transpose(1, 2).contiguous().transpose(1, 2), a, a, a, u)
    with pytest.raises(ValueError):
        ops.rwkv6_wkv(a, a, a, a, u.cpu())
    with pytest.raises(RuntimeError):  # a split the head dim does not have
        ops._launch(a, a, a, a, u, None, torch.float32, 2)


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
    x = torch.zeros(1 * 8 * 2 * 64 + 1, device=card, dtype=torch.bfloat16)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError):  # flash_wgmma reads through TMA: 16-byte aligned only
        flash_attention_bshd(x, x, x)
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


@pytest.mark.parametrize("s", [1, 63, 200, 2048])
@pytest.mark.parametrize("h,hkv,d", [(8, 2, 160), (10, 1, 256)])
def test_flash_mma_matches_plain_at_wide_heads(card, s, h, hkv, d):
    """flash_mma at pixtral_12b's head dim (160, H/Hkv = 4; the DMAX=256
    instantiation) and recurrentgemma_2b's (256, one KV head), ragged S,
    per output row against the plain version (2e-2 in bf16)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    g = torch.Generator(device=card).manual_seed(s * d + h)
    q = torch.randn(2, s, h, d, generator=g, device=card).bfloat16()
    k = torch.randn(2, s, hkv, d, generator=g, device=card).bfloat16()
    v = torch.randn(2, s, hkv, d, generator=g, device=card).bfloat16()
    before = kernels.VARIANT_LAUNCHES["flash_attention"]["flash_mma"]
    got = flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    assert kernels.VARIANT_LAUNCHES["flash_attention"]["flash_mma"] == before + 1
    assert _row_rel_err(got, flash_attention_bshd(q, k, v, use_kernel=False)) <= FLASH_TOL[torch.bfloat16]


def test_flash_forced_kind_launches_that_variant(card):
    """kind="flash_mma" at D=128 (where the wrapper would take flash_wgmma)
    launches and counts flash_mma and matches plain per row; a variant that
    cannot take the shape is refused by the launcher."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(2, 200, 8, 128, generator=g, device=card).bfloat16()
    k, v = (torch.randn(2, 200, 2, 128, generator=g, device=card).bfloat16() for _ in range(2))
    before = dict(kernels.VARIANT_LAUNCHES["flash_attention"])
    got = flash_attention_bshd(q, k, v, kind="flash_mma")
    after = kernels.VARIANT_LAUNCHES["flash_attention"]
    assert after["flash_mma"] == before["flash_mma"] + 1 and after["flash_wgmma"] == before["flash_wgmma"]
    assert _row_rel_err(got, flash_attention_bshd(q, k, v, use_kernel=False)) <= FLASH_TOL[torch.bfloat16]
    q = torch.zeros(1, 8, 2, 160, device=card, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        flash_attention_bshd(q, q, q, kind="flash_wgmma")


def test_flash_mma_is_strictly_causal_at_d256(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    g = torch.Generator(device=card).manual_seed(6)
    q = torch.randn(2, 384, 10, 256, generator=g, device=card).bfloat16()
    k, v = (torch.randn(2, 384, 1, 256, generator=g, device=card).bfloat16() for _ in range(2))
    o1 = flash_attention_bshd(q, k, v)
    for cut in (200, 256):  # inside a key tile, and at a tile boundary
        k2, v2 = k.clone(), v.clone()
        k2[:, cut:], v2[:, cut:] = 99.0, -99.0
        assert torch.equal(o1[:, :cut], flash_attention_bshd(q, k2, v2)[:, :cut])


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "granite_3_2b", "qwen15_110b", "qwen2_moe_a27b",
                                  "moonshot_v1_16b_a3b", "recurrentgemma_2b", "pixtral_12b", "whisper_tiny"])
def test_family_decode_on_card_matches_forward(card, arch):
    """The other families at smoke size in float32: flash runs once per
    attention layer of the prefill, and cached decode reproduces the
    kernel path's teacher-forced logits to 2e-3 (a VLM's decode runs on
    text alone; Whisper's after priming its cross cache)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models.whisper import whisper_prime_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).smoke()
    params = models.init(cfg, torch.Generator(device=card).manual_seed(0), card)
    g = torch.Generator(device=card).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=g, device=card)}
    cache = models.init_cache(cfg, 2, 40, card)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(2, 0, cfg.d_model, device=card)
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.randn(2, cfg.enc_seq_len, cfg.d_model, generator=g, device=card)
        cache = whisper_prime_cache(cfg, params, cache, batch["enc_embeds"])
    before = kernels.LAUNCHES["flash_attention"]
    full = models.forward(cfg, params, batch)
    n_attn = cfg.n_layers if cfg.family == "audio" else cfg.layer_kinds().count("attn")
    # recurrentgemma's 40 positions pass its window of 16: the block-local form, no kernel
    assert kernels.LAUNCHES["flash_attention"] == before + (0 if cfg.local_window else n_attn)
    dec = []
    for t in range(40):
        logits, cache = models.decode_step(cfg, params, cache, batch["tokens"][:, t], t)
        dec.append(logits)
    torch.testing.assert_close(torch.stack(dec, 1), full, rtol=2e-3, atol=2e-3)


def _smoke_layer(arch, card):
    """The first layer of ``arch``'s float32 smoke model, on the CPU and on
    the card, and an input."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models.lm import _layers

    cfg = get_config(arch).smoke()
    params = models.init(cfg, torch.Generator().manual_seed(0), "cpu")
    kind, lp = next(_layers(params, cfg))
    x = torch.randn(2, 300, cfg.d_model, generator=torch.Generator().manual_seed(1))
    return cfg, kind, lp, {k: v.to(card) for k, v in lp.items()}, x


def test_moe_prefill_layer_on_card_matches_cpu(card):
    """One qwen2_moe_a27b prefill layer (flash attention, then the sorted
    MoE dispatch at capacity 1.25, as a prefill runs it) on the
    card against the same layer on the CPU, float32."""
    from repro_torch.models.lm import _apply_layer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, kind, lp, lp_card, x = _smoke_layer("qwen2_moe_a27b", card)
    cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    pos = torch.arange(300).expand(2, 300)
    want = _apply_layer(kind, lp, x, cfg, pos, True)
    before = kernels.LAUNCHES["flash_attention"]
    got = _apply_layer(kind, lp_card, x.to(card), cfg, pos.to(card), True)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert _rel_err(got.cpu(), want) <= 1e-5


def test_rglru_block_on_card_matches_cpu(card):
    """recurrentgemma_2b's RG-LRU block (conv, gates, the doubling scan)
    on the card against the CPU, float32, from a carried state."""
    from repro_torch.models import rglru
    from repro_torch.models.common import sub

    cfg, kind, lp, lp_card, x = _smoke_layer("recurrentgemma_2b", card)
    assert kind == "rglru"
    g = torch.Generator().manual_seed(2)
    h0, conv0 = torch.randn(2, cfg.d_rnn, generator=g), torch.randn(2, cfg.conv_width - 1, cfg.d_rnn, generator=g)
    want, (wh, wc) = rglru.rglru_block(sub(lp, "rec"), x, h0, conv0)
    got, (gh, gc) = rglru.rglru_block(sub(lp_card, "rec"), x.to(card), h0.to(card), conv0.to(card))
    for a, b in ((got, want), (gh, wh), (gc, wc)):
        assert _rel_err(a.cpu(), b) <= 1e-5


# ------------------------------------------------------ the planned pipeline
def _padded_middle_operator(card, n=8, m=16):
    """A batched engine and the padded operands (A, W_j, W_{j+1}, B, theta)
    of the middle pair of an n-site Heisenberg chain after one sweep at
    bond m on the card."""
    from repro_torch.core import run_dmrg
    from repro_torch.core.env import extend_left, extend_right, get_contractor, left_edge, right_edge
    from repro_torch.core.models import heisenberg_chain_system
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.dist.batch import pad_block_sparse

    space, terms = heisenberg_chain_system(n)
    mpo = compress_mpo(build_mpo(space, terms, n, device=card), cutoff=1e-13)
    res = run_dmrg(space, terms, n, bond_schedule=(m,), sweeps_per_bond=1, davidson_iters=2,
                   algo="batched", jit_matvec=True, mpo=mpo, device=card)
    T, j = res.mps.tensors, n // 2 - 1
    engine = get_contractor("batched", card)
    A = left_edge(T[0], mpo[0])
    for i in range(j):
        A = extend_left(A, T[i], mpo[i], engine)
    B = right_edge(T[n - 1], mpo[n - 1])
    for i in range(n - 2, j, -1):
        B = extend_right(B, T[i + 1], mpo[i + 1], engine)
    theta = engine(T[j], T[j + 1], ((2,), (0,)))
    ops = [pad_block_sparse(t) for t in (A, mpo[j], mpo[j + 1], B, theta)]
    return engine, mpo, T, ops


def _bst_rel_err(got, want):
    assert set(got.blocks) == set(want.blocks)
    scale = max(b.abs().max().item() for b in want.blocks.values())
    return max((got.blocks[k] - want.blocks[k]).abs().max().item() for k in want.blocks) / scale


def test_graph_replay_matches_eager_matvec_and_reads_fresh_inputs(card):
    """The graphed matvec equals the eager batched matvec to 1e-12 relative
    on every replay, and two replays with different x each equal their own
    eager result (no replay reads the previous call's x)."""
    from repro_torch.dist.graphs import GraphCache
    from repro_torch.tensor.blocksparse import BlockSparseTensor

    engine, _, _, (A, Wj, Wj1, B, x1) = _padded_middle_operator(card)
    g = torch.Generator(device=card).manual_seed(3)
    x2 = BlockSparseTensor(x1.indices, {k: torch.randn(b.shape, generator=g, dtype=b.dtype, device=card)
                                        for k, b in x1.blocks.items()}, x1.charge)
    engine.graphs = GraphCache()
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    results = [mv(x) for x in (x1, x2, x1, x2)]  # capture and replay, then replays
    assert engine.graphs.captures == 1 and engine.graphs.replays == 4
    for x, got in zip((x1, x2, x1, x2), results):
        assert _bst_rel_err(got, engine.two_site_matvec(A, Wj, Wj1, B, x)) <= 1e-12
    assert _bst_rel_err(results[1], results[0]) > 1e-3


def test_graph_replay_counts_its_recorded_launches(card):
    """kernels.LAUNCHES grows on every replay by the block GEMM launches the
    graph recorded, as many as the eager matvec makes; the capture itself,
    which runs nothing, counts none."""
    engine, _, _, (A, Wj, Wj1, B, x) = _padded_middle_operator(card)
    counts = lambda: dict(kernels.VARIANT_LAUNCHES["block_gemm"])  # noqa: E731
    before = counts()
    engine.two_site_matvec(A, Wj, Wj1, B, x)
    eager = {k: n - before[k] for k, n in counts().items()}
    assert sum(eager.values()) > 0
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    for _ in range(3):  # capture and replay, then replays
        before = counts()
        mv(x)
        assert {k: n - before[k] for k, n in counts().items()} == eager


def test_env_graph_matches_eager_env_update(card):
    """The fused environment update replayed as a graph equals the same
    update run eagerly, and the three-call extend_left/extend_right, to
    1e-12 relative."""
    from repro_torch.core.env import extend_left, extend_right, left_edge, right_edge
    from repro_torch.dist.envcore import EnvironmentEngine

    engine, mpo, T, _ = _padded_middle_operator(card)
    n = len(T)
    eager = EnvironmentEngine(jit=False)
    A = left_edge(T[0], mpo[0])
    B = right_edge(T[n - 1], mpo[n - 1])
    for _ in range(2):  # capture, then replay
        for j in range(n - 1):
            want = extend_left(A, T[j], mpo[j], engine)
            for got in (engine.env_update_left(A, T[j], mpo[j]), eager.update_left(A, T[j], mpo[j])):
                assert _bst_rel_err(got, want) <= 1e-12
            A = want
        for j in range(n - 1, 0, -1):
            want = extend_right(B, T[j], mpo[j], engine)
            assert _bst_rel_err(engine.env_update_right(B, T[j], mpo[j]), want) <= 1e-12
            B = want
        A, B = left_edge(T[0], mpo[0]), right_edge(T[n - 1], mpo[n - 1])
    assert engine.graphs.replays > 0


def test_bucket_gemm_matches_plain(card):
    """Every bucket of the middle-bond matvec through the kernel equals its
    plain version to 1e-12 relative (exact shapes, no extents)."""
    from repro_torch.dist.batch import bucket_operands, matricize_lhs, matricize_rhs
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref

    engine, _, _, (A, Wj, Wj1, B, x) = _padded_middle_operator(card)
    t, n_buckets = x, 0
    for i, axes in enumerate([((2,), (0,)), ((1, 2), (0, 2)), ((4, 1), (0, 2)), ((4, 1), (1, 2))]):
        a, b = (A, t) if i == 0 else (t, (Wj, Wj1, B)[i - 1])
        plan = engine.cache.get(a, b, axes)
        am, bm = matricize_lhs(a, plan.keep_a, plan.ax_a), matricize_rhs(b, plan.keep_b, plan.ax_b)
        for bucket, oi in zip(plan.batched.buckets, plan.batched.device_tables(card)):
            lhs, rhs = bucket_operands(bucket, am, bm)
            got = block_sparse_matmul(lhs, rhs, oi, len(bucket.out_keys), work=bucket.work)
            want = block_sparse_matmul_ref(lhs, rhs, oi, len(bucket.out_keys))
            assert (got - want).abs().max().item() <= 1e-12 * max(want.abs().max().item(), 1e-300)
            n_buckets += 1
        t = engine(a, b, axes)
    assert n_buckets > 4


def test_graph_capture_error_raises(card):
    """A body that syncs with the host cannot be captured: the capturing
    call raises, and so does every later call of the structure (nothing
    runs it eagerly instead)."""
    from repro_torch.dist.graphs import GraphCache

    cache = GraphCache()
    x = torch.ones(8, dtype=torch.float64, device=card)

    def body(_fixed, live, _keep):
        return [live[0] * float(live[0].sum().item())]

    for _ in range(2):
        with pytest.raises(RuntimeError):
            cache.run("syncs", body, lambda: ([(8,)], None, None), [x])
    assert cache.captures == 0 and cache.replays == 0


def test_graph_replay_outlives_the_plans_caches(card):
    """A captured matvec reads its plans' device tables by address.  With
    the plan cache dropped, the shared work lists cleared, the memory they
    held free for reuse and refilled with zeros, a replay still equals the
    eager matvec to 1e-12 relative: the graph's entry keeps its plans."""
    import gc

    from repro_torch.dist.graphs import GraphCache
    from repro_torch.dist.plan import PlanCache
    from repro_torch.kernels.block_gemm import work

    engine, _, _, (A, Wj, Wj1, B, x) = _padded_middle_operator(card)
    engine.cache, engine.graphs = PlanCache(), GraphCache()
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    mv(x)  # capture and replay
    want = engine.two_site_matvec(A, Wj, Wj1, B, x)
    engine.cache = PlanCache(maxsize=1)
    work._SHARED.clear()
    gc.collect()
    torch.cuda.synchronize()
    # take every free block of the allocator's small pool and zero it: a
    # freed table would now read as zeros
    reserved, scratch = torch.cuda.memory_reserved(card), []
    while torch.cuda.memory_reserved(card) == reserved and len(scratch) < 1 << 16:
        scratch.append(torch.zeros(128, dtype=torch.int32, device=card))
    got = mv(x)
    torch.cuda.synchronize()
    assert engine.graphs.captures == 1 and engine.graphs.replays == 2
    assert _bst_rel_err(got, want) <= 1e-12


def test_planned_split_syncs_twice_per_bucket_and_once_more(card):
    """A planned split on the card syncs the host 2 x buckets + 1 times:
    twice inside each bucket's torch.linalg.svd (cuSOLVER's info checks)
    and once at the singular values' read, as stats()["host_syncs"]
    counts.  A change that adds a sync fails here."""
    import warnings

    from repro_torch.dist.decomp import DecompositionEngine

    _, _, _, (*_, theta) = _padded_middle_operator(card)
    dec = DecompositionEngine()
    dec.svd_split(theta, 2, 16)  # builds the plan and uploads its tables
    torch.cuda.synchronize()
    before = dec.stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dec.svd_split(theta, 2, 16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = dec.stats()
    buckets = after["buckets"] - before["buckets"]
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert buckets >= 2
    assert len(syncs) == 2 * buckets + 1 == after["host_syncs"] - before["host_syncs"]


def test_batched_jit_run_on_card_matches_csr(card):
    """run_dmrg(algo="batched", jit_matvec=True) on the card launches the
    block GEMM from graph replays and reaches the csr run's 3x2 energy to
    1e-10 and ED to 1e-8."""
    from repro_torch.core import run_dmrg
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.siteops import spin_half_space

    sp, terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    kw = dict(bond_schedule=(8, 16), davidson_iters=6)
    e_csr = run_dmrg(sp, terms, 6, algo="csr", **kw).energy
    res = run_dmrg(sp, terms, 6, algo="batched", jit_matvec=True, **kw)
    assert sum(s.graphs["graph_replays"] for s in res.sweep_stats) > 0
    assert sum(sum(s.block_gemm_launches.values()) for s in res.sweep_stats) > 0
    assert abs(res.energy - e_csr) < 1e-10
    assert abs(res.energy - ground_energy(sp, terms, 6, charge=(0,))) <= 1e-8


# ------------------------------------------------- the engine front door
def test_auto_graphed_matvec_matches_eager(card):
    """Under "auto" the graphed matvec routes each step by the cost model's
    choice (on DMRG structures, list: the batched dispatch charge exceeds
    the pair count) and equals the eager matvec to 1e-12 relative on every
    replay; no ladder recovers anything."""
    from repro_torch.dist.engine import ContractionEngine

    _, _, _, (A, Wj, Wj1, B, x) = _padded_middle_operator(card)
    engine = ContractionEngine("auto")
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    got = [mv(x) for _ in range(3)]
    steps = [engine.backend_for(p) for p in engine._prepare_chain(x, (A, Wj, Wj1, B), card)]
    assert engine.graphs.captures == 1 and engine.graphs.replays == 3
    assert engine.backend_counts == {b: steps.count(b) for b in engine.backend_counts}
    want = engine.matvec_fn(A, Wj, Wj1, B, jit=False)(x)
    assert max(_bst_rel_err(y, want) for y in got) <= 1e-12
    assert engine.retries == {} and engine.degradations == {}


def _many_partner_operands(card):
    """Two order-3 tensors whose blocks each meet several partners in few
    shape buckets, contracted over one mode."""
    from repro_torch.tensor.blocksparse import BlockSparseTensor
    from repro_torch.tensor.qn import Index

    rng = np.random.default_rng(0)

    def sec():
        return tuple(((q,), int(rng.integers(1, 3))) for q in range(-2, 3))

    sx, sy, ss, sz, sw = (sec() for _ in range(5))
    g = torch.Generator(device=card).manual_seed(0)
    a = BlockSparseTensor.random([Index(sx, 1), Index(sy, -1), Index(ss, 1)], (0,), generator=g)
    b = BlockSparseTensor.random([Index(ss, -1), Index(sz, 1), Index(sw, -1)], (0,), generator=g)
    return a, b, ((2,), (0,))


def test_auto_launches_the_block_gemm_where_it_chooses_batched(card):
    """A contraction whose blocks each meet several partners in few shape
    buckets: "auto" chooses batched and launches the block GEMM on it, equal
    to the list backend to 1e-12 relative."""
    from repro_torch.dist.engine import ContractionEngine

    a, b, ax = _many_partner_operands(card)
    engine = ContractionEngine("auto")
    assert engine.choose_backend(engine.cache.get(a, b, ax)) == "batched"
    before = kernels.LAUNCHES["block_gemm"]
    got = engine(a, b, ax)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["block_gemm"] > before and engine.backend_counts["batched"] == 1
    assert _bst_rel_err(got, ContractionEngine("list")(a, b, ax)) <= 1e-12


@pytest.mark.parametrize("failure", ["build", "launch"])
@pytest.mark.parametrize("backend", ["batched", "csr"])
def test_block_gemm_failure_propagates_through_the_engine(card, monkeypatch, backend, failure):
    """A block GEMM that does not build, or whose launch returns an error,
    raises out of the engine on the card: no ladder rung computes the
    contraction on a library path in its place, and nothing is counted."""
    from repro_torch.dist.engine import ContractionEngine
    from repro_torch.kernels.block_gemm import ops

    class Failing:
        @staticmethod
        def block_gemm_launch(*args):
            return 1  # cudaErrorInvalidValue, returned before any work is queued

    def library():
        if failure == "build":
            raise RuntimeError("nvcc failed")
        return Failing

    a, b, ax = _many_partner_operands(card)
    monkeypatch.setattr(ops, "_library", library)
    engine = ContractionEngine(backend)
    with pytest.raises(RuntimeError, match="nvcc failed" if failure == "build" else "launch failed"):
        engine(a, b, ax)
    assert engine.retries == {} and engine.degradations == {}


def test_gemm_nan_does_not_fire_inside_a_capture(card):
    """The batch.gemm_nan hook is skipped while a graph is captured (and a
    replay runs no Python), so a graphed matvec stays finite under an armed
    fault; an eager call fires it."""
    from repro_torch.dist import faults
    from repro_torch.dist.engine import ContractionEngine

    _, _, _, (A, Wj, Wj1, B, x) = _padded_middle_operator(card)
    engine = ContractionEngine("batched")
    faults.registry.clear()
    try:
        with faults.inject("batch.gemm_nan", count=math.inf) as f:
            ys = [engine.matvec_fn(A, Wj, Wj1, B, jit=True)(x) for _ in range(2)]
            assert f.fired == 0 and engine.graphs.captures == 1
            assert all(torch.isfinite(b).all() for y in ys for b in y.blocks.values())
            bad = engine.matvec_fn(A, Wj, Wj1, B, jit=False)(x)
            assert f.fired > 0 and any(torch.isnan(b).any() for b in bad.blocks.values())
    finally:
        faults.registry.clear()
    assert _bst_rel_err(ys[0], engine.matvec_fn(A, Wj, Wj1, B, jit=False)(x)) <= 1e-12


def test_clean_auto_run_has_every_ladder_counter_zero(card):
    """run_dmrg(algo="auto", jit_matvec=True) on the card reaches ED on the
    3x2 case, and no ladder absorbed anything: a fault a ladder recovered
    would show in these counters."""
    from repro_torch.core import DMRGEngine, ground_energy
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.core.mps import neel_states, product_state_mps
    from repro_torch.core.siteops import spin_half_space

    sp, terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    mpo = compress_mpo(build_mpo(sp, terms, 6, device=card), cutoff=1e-13)
    eng = DMRGEngine(product_state_mps(sp, neel_states(sp, 6), device=card), mpo, algo="auto", jit_matvec=True,
                     davidson_iters=6, device=card)
    stats = [eng.sweep(max_bond=m) for m in (8, 8, 16, 16)]
    st = eng.contract_fn.stats()
    assert st["retries"] == {} and st["degradations"] == {}
    assert st["decomp"]["retries"] == 0 and not any(st["decomp"]["degradations"].values())
    assert all(s.pair_retries == 0 for s in stats)
    assert sum(s.graphs["graph_replays"] for s in stats) > 0
    assert abs(stats[-1].energy - ground_energy(sp, terms, 6, charge=(0,))) <= 1e-8


# ------------------------------------------------------------------ serving
SERVE_J = (0.9, 1.0, 1.1, 1.2)


def _serve_specs(n=10, m=16):
    from repro_torch.serve import ProblemSpec

    return [ProblemSpec.make("heisenberg", n, J=j, h=0.3, max_bond=m, sweeps_per_bond=1, davidson_iters=4)
            for j in SERVE_J]


def _stacked_middle_operator(card):
    """A stacked run of the four served problems on the card, and the padded
    stacked (A, W_j, W_{j+1}, B, theta) of its middle pair."""
    from repro_torch.core.env import left_edge, right_edge
    from repro_torch.serve import StackedOps, build_problem, run_dmrg_multi
    from repro_torch.serve.stacked import broadcast_tensor, pad_stacked

    specs = _serve_specs()
    built = [build_problem(s) for s in specs]
    n = specs[0].n_sites
    ops = StackedOps()
    res = run_dmrg_multi(built[0][0], n, [m for _, m in built], bond_schedule=specs[0].bond_schedule,
                         sweeps_per_bond=1, davidson_iters=4, ops=ops, device=card)
    eng = res.engine
    T, W, j = eng.T, eng.W, n // 2 - 1
    A = broadcast_tensor(left_edge(T[0], W[0]), len(specs))
    for i in range(j):
        A = ops.env_update("left", A, T[i], W[i])
    Bx = broadcast_tensor(right_edge(T[n - 1], W[n - 1]), len(specs))
    for i in range(n - 2, j, -1):
        Bx = ops.env_update("right", Bx, T[i + 1], W[i + 1])
    theta = ops.contract(T[j], T[j + 1], ((2,), (0,)))
    return ops, built, [pad_stacked(t) for t in (A, W[j], W[j + 1], Bx, theta)]


def test_folded_launch_matches_plain_and_per_problem_launches(card):
    """Each bucket of a stacked middle-bond matvec is ONE block GEMM launch
    over the B*P folded pairs: it equals its plain version (1e-12 relative)
    and the B per-problem launches (1e-13 relative)."""
    from repro_torch.dist.batch import bucket_operands, matricize_lhs, matricize_rhs
    from repro_torch.dist.engine import MATVEC_AXES
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref
    from repro_torch.serve.stacked import unstack_tensor

    ops, _, (A, Wj, Wj1, Bx, x) = _stacked_middle_operator(card)
    nb, t, n_buckets = len(SERVE_J), x, 0
    for i, axes in enumerate(MATVEC_AXES):
        a, b = (A, t) if i == 0 else (t, (Wj, Wj1, Bx)[i - 1])
        plan = ops.engine.cache.get(a, b, axes)
        am, bm = matricize_lhs(a, plan.keep_a, plan.ax_a), matricize_rhs(b, plan.keep_b, plan.ax_b)
        singles = plan.batched.device_tables(card)
        for bi, (bucket, oi) in enumerate(zip(plan.batched.buckets, plan.batched.device_tables(card, nb))):
            O = len(bucket.out_keys)
            lhs, rhs = bucket_operands(bucket, am, bm)
            before = kernels.LAUNCHES["block_gemm"]
            got = block_sparse_matmul(lhs, rhs, oi, nb * O, work=bucket.folded_work(nb))
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["block_gemm"] == before + 1
            want = block_sparse_matmul_ref(lhs, rhs, oi, nb * O)
            scale = max(want.abs().max().item(), 1e-300)
            assert (got - want).abs().max().item() <= 1e-12 * scale
            one_oi = singles[bi]
            for p in range(nb):
                ap = matricize_lhs(unstack_tensor(a, p), plan.keep_a, plan.ax_a)
                bp = matricize_rhs(unstack_tensor(b, p), plan.keep_b, plan.ax_b)
                l1, r1 = bucket_operands(bucket, ap, bp)
                one = block_sparse_matmul(l1, r1, one_oi, O, work=bucket.work)
                assert (got.view(nb, O, bucket.m, bucket.n)[p] - one).abs().max().item() <= 1e-13 * scale
            n_buckets += 1
        t = ops.contract(a, b, axes)
    assert n_buckets > 4


def test_served_slot_captures_nothing_after_warmup(card):
    """A warmed service serves a slot of its warmup problems with zero
    captures, launching the block GEMM, with energies 1e-10 from the single
    runs and a zero recovery ledger."""
    from repro_torch.core import run_dmrg
    from repro_torch.serve import DMRGService
    from repro_torch.tensor.blocksparse import BlockSparseTensor

    specs = _serve_specs()
    svc = DMRGService(max_batch=4, batch_wait_s=30.0, device=card)
    try:
        svc.warmup(specs, sizes=(4,))
        assert svc.ops.retraces > 0
        before = kernels.LAUNCHES["block_gemm"]
        rids = [svc.submit(s) for s in specs]
        recs = [svc.result(r, timeout=600) for r in rids]
        st = svc.stats()
        assert kernels.LAUNCHES["block_gemm"] > before
        assert st["retraces"] == 0 and all(r["batch_size"] == 4 for r in recs)
        assert not any((st["retries"], st["bisections"], st["worker_restarts"], st["unrecovered_errors"]))
        assert not any(st["ladders"]["svd_degradations"].values()) and st["ladders"]["svd_retries"] == 0
        for spec, rec in zip(specs, recs):
            from repro_torch.serve import build_problem

            space, mpo = build_problem(spec)
            mpo = [BlockSparseTensor(w.indices, {k: b.to(card) for k, b in w.blocks.items()}, w.charge) for w in mpo]
            ref = run_dmrg(space, None, spec.n_sites, bond_schedule=spec.bond_schedule, sweeps_per_bond=1,
                           davidson_iters=4, mpo=mpo, algo="batched", jit_matvec=True, device=card)
            assert abs(rec["energy"] - ref.energy) < 1e-10
    finally:
        svc.shutdown()


def test_submit_during_a_capture(card):
    """Requests submitted from another thread while the worker captures
    graphs build their MPOs on the CPU and disturb no capture: every
    request completes, equal to a slot solved with nothing running beside
    it."""
    from repro_torch.serve import DMRGService

    specs = _serve_specs()
    quiet = DMRGService(max_batch=4, batch_wait_s=30.0, device=card)
    try:
        want = [quiet.result(r, timeout=600)["energy"] for r in [quiet.submit(s) for s in specs]]
    finally:
        quiet.shutdown()

    svc = DMRGService(max_batch=4, batch_wait_s=0.0, device=card)
    state = {"capturing": 0, "overlapped": 0}
    capture = svc.ops.engine.graphs._capture

    def counted(*args):
        state["capturing"] += 1
        try:
            return capture(*args)
        finally:
            state["capturing"] -= 1

    svc.ops.engine.graphs._capture = counted
    try:
        rids = [(svc.submit(specs[0]), 0)]

        def submitter():
            for i in [1, 2, 3] * 3:
                busy = state["capturing"] > 0
                rids.append((svc.submit(specs[i]), i))
                state["overlapped"] += busy

        th = threading.Thread(target=submitter)
        th.start()
        th.join(timeout=600)
        assert not th.is_alive()
        recs = [(svc.result(r, timeout=600), i) for r, i in rids]
        assert state["overlapped"] > 0
        assert all(r["status"] == "done" for r, _ in recs) and svc.stats()["failed"] == 0
        assert all(abs(r["energy"] - want[i]) < 1e-10 for r, i in recs)
    finally:
        svc.shutdown()


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_block_gemm_failure_fails_the_served_requests(card, monkeypatch, failure):
    """A block GEMM that does not build or launch is neither retried nor
    bisected by the service: the slot's requests fail carrying the error,
    and the stats count it."""
    from repro_torch.kernels.block_gemm import ops
    from repro_torch.serve import DMRGService

    class Failing:
        @staticmethod
        def block_gemm_launch(*args):
            return 1

    def library():
        if failure == "build":
            raise RuntimeError("nvcc failed")
        return Failing

    monkeypatch.setattr(ops, "_library", library)
    svc = DMRGService(max_batch=2, batch_wait_s=30.0, device=card)
    try:
        rids = [svc.submit(s) for s in _serve_specs()[:2]]
        for rid in rids:
            with pytest.raises(RuntimeError, match="nvcc failed" if failure == "build" else "launch failed"):
                svc.result(rid, timeout=600)
        st = svc.stats()
        assert (st["failed"], st["retries"], st["bisections"], st["unrecovered_errors"]) == (2, 0, 0, 1)
    finally:
        svc.shutdown()


def test_stacked_split_syncs_as_a_single_split(card):
    """A stacked split of B problems syncs the host as one split does,
    2 x buckets + 1 times (one SVD per bucket over every problem's sectors,
    one read of all the singular values), as stats()["host_syncs"]
    counts; the per-problem masks cross without a sync."""
    import warnings

    from repro_torch.serve import svd_split_multi

    ops, _, (*_, theta) = _stacked_middle_operator(card)
    svd_split_multi(theta, 2, 16, ops=ops)  # builds the plan and uploads its tables
    torch.cuda.synchronize()
    before = ops.engine.decomp.stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            svd_split_multi(theta, 2, 16, ops=ops)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = ops.engine.decomp.stats()
    buckets = after["buckets"] - before["buckets"]
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert buckets >= 1
    assert len(syncs) == 2 * buckets + 1 == after["host_syncs"] - before["host_syncs"]


# ------------------------------------------------------------ distributed
@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (2, 4)])
def test_spmd_chunk_gemm_matches_plain(card, grid):
    """Every rank's chunk of an uneven bucket (P=7 pairs, N=45 columns) on
    the kernel against the plain version, 1e-12 relative; one launch per
    chunk with pairs and columns."""
    from repro_torch.dist.spmd import chunk_bounds, chunk_gemm

    rows, cols = grid
    rng = np.random.default_rng(2)
    P, M, K, N, O = 7, 37, 64, 45, 4
    lhs = torch.from_numpy(rng.standard_normal((P, M, K))).to(card)
    rhs = torch.from_numpy(rng.standard_normal((P, K, N))).to(card)
    oi = np.array([0, 0, 1, 1, 1, 3, 3], np.int32)
    for r in range(rows):
        for c in range(cols):
            (lo, hi), (c0, c1), _, _ = chunk_bounds(P, N, rows, cols, r, c)
            if c1 == c0:
                continue
            chunk_rhs = rhs[lo:hi, :, c0:c1].contiguous()
            before = kernels.LAUNCHES["block_gemm"]
            got = chunk_gemm(lhs[lo:hi], chunk_rhs, oi[lo:hi], O)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["block_gemm"] == before + 1
            want = block_sparse_matmul_ref(lhs[lo:hi], chunk_rhs, oi[lo:hi], O)
            assert (got - want).abs().max().item() <= 1e-12 * max(want.abs().max().item(), 1e-300)


def test_spmd_chunks_stay_sorted_and_zero_fill_on_the_kernel(card):
    """A row chunk's slice of a sorted ``oi`` is sorted and reaches only some
    output slots: the kernel writes exact zeros in the others, an empty
    chunk gives all zeros, and the chunks add up to the whole bucket."""
    from repro_torch.dist.spmd import chunk_bounds, chunk_gemm

    rng = np.random.default_rng(3)
    P, M, K, N, O = 5, 16, 24, 20, 5
    lhs = torch.from_numpy(rng.standard_normal((P, M, K))).to(card)
    rhs = torch.from_numpy(rng.standard_normal((P, K, N))).to(card)
    oi = np.array([0, 0, 2, 4, 4], np.int32)
    total = torch.zeros((O, M, N), dtype=torch.float64, device=card)
    for r in range(4):  # 4 row ranks: chunks of 2, 2, 1 and 0 pairs
        (lo, hi), _, _, _ = chunk_bounds(P, N, 4, 1, r, 0)
        assert np.all(np.diff(oi[lo:hi]) >= 0)
        got = chunk_gemm(lhs[lo:hi], rhs[lo:hi], oi[lo:hi], O)
        for o in set(range(O)) - set(oi[lo:hi].tolist()):
            assert not got[o].any()
        total += got
    want = block_sparse_matmul_ref(lhs, rhs, oi, O)
    assert (total - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def test_world1_nccl_spmd_bucket_gemm(card):
    """A world of one rank with NCCL: the split bucket GEMM issues its
    all_reduce and all_gather on the card and equals the plain version."""
    from repro_torch.dist import spmd
    from repro_torch.dist.shard import make_block_mesh

    mesh = make_block_mesh(device="cuda")
    assert torch.distributed.get_backend() == "nccl" and mesh.size() == 1
    rng = np.random.default_rng(4)
    lhs = torch.from_numpy(rng.standard_normal((6, 32, 16))).to(card)
    rhs = torch.from_numpy(rng.standard_normal((6, 16, 40))).to(card)
    oi = np.array([0, 1, 1, 1, 2, 2], np.int32)
    before, launches = spmd.stats(), kernels.LAUNCHES["block_gemm"]
    got = spmd.spmd_bucket_gemm(lhs, rhs, oi, 3, mesh=mesh)
    torch.cuda.synchronize()
    after = spmd.stats()
    assert after["all_reduce_calls"] - before["all_reduce_calls"] == 1
    assert after["all_gather_calls"] - before["all_gather_calls"] == 1
    assert kernels.LAUNCHES["block_gemm"] == launches + 1
    want = block_sparse_matmul_ref(lhs, rhs, oi, 3)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def test_spmd_run_on_card_matches_batched(card):
    """``run_dmrg(spmd=True)`` at a world of one rank on the 3x2 lattice:
    every contraction on the spmd rung, the block GEMM launched, no graph
    captured, the energy within 1e-10 of the graphed batched run."""
    from repro_torch.core import run_dmrg
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.siteops import spin_half_space

    sp, terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    kw = dict(bond_schedule=(8, 16), davidson_iters=4, device=card)
    ref = run_dmrg(sp, terms, 6, algo="batched", jit_matvec=True, **kw)
    before = kernels.LAUNCHES["block_gemm"]
    res = run_dmrg(sp, terms, 6, algo="batched", spmd=True, **kw)
    assert kernels.LAUNCHES["block_gemm"] > before
    st = res.engine_stats
    assert st["backend_counts"]["spmd"] > 0 and st["graphs"]["graph_captures"] == 0
    assert st["policy"]["mismatches"] == 0
    assert abs(res.energy - ref.energy) < 1e-10


# ------------------------------------------------------- backward kernels
# The backward kernels against autograd through the plain versions (the
# plain version of each backward), per tensor ||got - want|| / ||want||.
# float32: the sums run in other orders; bf16: each side rounds its
# gradients (and the kernel its forward output, which its Delta reads) to
# bf16 once, 2^-9 relative, and bwd_mma rounds P and dS to bf16 for its
# tensor-core products (read 3.3e-3 on an H100).  A gradient that the plain version gives as
# exactly zero (dq and dk at S=1, where p = 1 and dP - Delta cancels; dlogw
# at T=1, which reaches only the dropped final state, where autograd gives
# None) is held to the limit relative to ||dO||: the kernel's cancellation
# leaves rounding of that scale.
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _l2_rel(got, want, scale_if_zero=0.0):
    """||got - want|| / ||want||, or / ``scale_if_zero`` where want is zero."""
    norm = 0.0 if want is None else want.double().norm().item()
    diff = got.double().norm() if norm == 0 else (got.double() - want.double()).norm()
    return (diff / max(norm or scale_if_zero, 1e-300)).item()


def _flash_grads(q, k, v, do, use_kernel):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    q, k, v = (a.detach().requires_grad_(True) for a in (q, k, v))
    flash_attention_bshd(q, k, v, use_kernel=use_kernel).backward(do)
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 1, 4, 4, 64),       # one token
    (2, 37, 4, 4, 16),      # GQA 1, ragged S, the smoke head dim
    (1, 130, 8, 2, 64),     # GQA 4, ragged over several tiles
    (1, 200, 8, 1, 128),    # GQA 8 (one KV head), llama3_8b's head dim
    (1, 100, 8, 2, 160),    # pixtral_12b's head dim
    (1, 150, 4, 1, 256),    # recurrentgemma_2b's head dim, one KV head
])
def test_flash_backward_matches_plain(card, dtype, b, s, h, hkv, d):
    from repro_torch.kernels.flash_attention.ops import bwd_variant

    g = torch.Generator(device=card).manual_seed(s * d + h)
    q = torch.randn(b, s, h, d, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device=card).to(dtype)
    do = torch.randn(b, s, h, d, generator=g, device=card).to(dtype)
    fwd, bwd = kernels.LAUNCHES["flash_attention"], dict(kernels.VARIANT_LAUNCHES["flash_attention_bwd"])
    got = _flash_grads(q, k, v, do, True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == fwd + 1
    kind = bwd_variant(dtype, d)
    assert kind == ("bwd_mma" if dtype == torch.bfloat16 and d <= 128 else "bwd_simple")
    assert kernels.VARIANT_LAUNCHES["flash_attention_bwd"] == {**bwd, kind: bwd[kind] + 1}
    for name, gt, want in zip("qkv", got, _flash_grads(q, k, v, do, False)):
        assert gt.dtype == dtype and gt.shape == want.shape
        assert _l2_rel(gt, want, do.double().norm().item()) <= BWD_TOL[dtype], name


def test_flash_backward_is_deterministic_and_causal(card):
    """Bitwise the same gradients twice (no atomics); a query's gradient
    does not depend on later keys, and the later keys receive none from
    earlier queries' loss."""
    g = torch.Generator(device=card).manual_seed(9)
    q, k, v = (torch.randn(1, 300, 8, 64, generator=g, device=card).bfloat16() for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    do = torch.randn(1, 300, 8, 64, generator=g, device=card).bfloat16()
    a, b = _flash_grads(q, k, v, do, True), _flash_grads(q, k, v, do, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    do2 = do.clone()
    do2[:, 200:] = 0  # the loss reads only the first 200 outputs
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:], v2[:, 200:] = 9.0, -9.0
    dq1, dk1, dv1 = _flash_grads(q, k, v, do2, True)
    dq2, _, _ = _flash_grads(q, k2, v2, do2, True)
    assert torch.equal(dq1[:, :200], dq2[:, :200])
    assert not dk1[:, 200:].any() and not dv1[:, 200:].any()


def test_flash_backward_refuses_misaligned_operands(card):
    """bwd_mma moves its operands in 16-byte pieces: a dout that is not
    16-byte aligned raises rather than taking another variant."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(1, 40, 2, 64, generator=g, device=card).bfloat16() for _ in range(3))
    out, lse = flash_ops._launch(q, k, v, with_lse=True)
    do = torch.randn(q.numel() + 1, generator=g, device=card).bfloat16()[1:].view(q.shape)
    before = dict(kernels.VARIANT_LAUNCHES["flash_attention_bwd"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops._launch_bwd(q, k, v, out, lse, do)
    assert kernels.VARIANT_LAUNCHES["flash_attention_bwd"] == before
    flash_ops._launch_bwd(q, k, v, out, lse, do.clone())


def _scan_grads(r, k, v, logw, u, do, use_kernel, state=None):
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    leaves = [a.detach().requires_grad_(True) for a in (r, k, v, logw, u)]
    out, _ = rwkv6_wkv(*leaves, state=state, out_dtype=do.dtype, use_kernel=use_kernel)
    out.backward(do)
    return [a.grad for a in leaves]


def _scan_inputs(card, dtype, b, t, h, n, seed, logw_max=6.0):
    g = torch.Generator(device=card).manual_seed(seed)
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=card)).to(dtype) for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=card).to(dtype)
    # log-decay from -exp(-8) down to -exp(logw_max) (the model's clip is exp(6))
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=card) * (logw_max + 8.0) - 8.0)
    u = 0.1 * torch.randn(h, n, generator=g, device=card)
    do = torch.randn(b, t, h, n, generator=g, device=card)
    return r, k, v, logw, u, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,n", [
    (2, 1, 3, 16),
    (1, 33, 2, 64),     # T ragged over two chunks
    (2, 100, 2, 16),    # four chunks, the last ragged
    (1, 70, 3, 32),
    (2, 64, 2, 64),
])
def test_scan_backward_matches_plain(card, dtype, b, t, h, n):
    r, k, v, logw, u, do = _scan_inputs(card, dtype, b, t, h, n, seed=t * n + b)
    before = dict(kernels.VARIANT_LAUNCHES["rwkv6_scan_bwd"])
    got = _scan_grads(r, k, v, logw, u, do, True)
    torch.cuda.synchronize()
    assert kernels.VARIANT_LAUNCHES["rwkv6_scan_bwd"] == {**before, f"n{n}": before[f"n{n}"] + 1}
    want = _scan_grads(r, k, v, logw, u, do, False)
    for name, gt, w, x in zip(("r", "k", "v", "logw", "u"), got, want, (r, k, v, logw, u)):
        assert gt.dtype == x.dtype and gt.shape == x.shape
        tol = SCAN_BWD_TOL[dtype if name in "rkv" else torch.float32]
        assert _l2_rel(gt, w, do.double().norm().item()) <= tol, name


def test_scan_backward_bf16_output_gradient_and_carried_state(card):
    """A bf16 wkv output (its gradient arrives in bf16) from a carried
    initial state that takes no gradient, over 3 chunks."""
    r, k, v, logw, u, do = _scan_inputs(card, torch.float32, 2, 90, 2, 64, seed=5)
    s0 = 0.1 * torch.randn(2, 2, 64, 64, generator=torch.Generator(device=card).manual_seed(6), device=card)
    do = do.bfloat16()
    got = _scan_grads(r, k, v, logw, u, do, True, state=s0)
    want = _scan_grads(r, k, v, logw, u, do, False, state=s0)
    for name, gt, w in zip(("r", "k", "v", "logw", "u"), got, want):
        assert _l2_rel(gt, w) <= SCAN_BWD_TOL[torch.float32], name


def test_scan_backward_is_deterministic(card):
    r, k, v, logw, u, do = _scan_inputs(card, torch.bfloat16, 2, 200, 4, 64, seed=7)
    a, b = _scan_grads(r, k, v, logw, u, do, True), _scan_grads(r, k, v, logw, u, do, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_scan_function_refuses_state_gradients(card):
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    r, k, v, logw, u, _ = _scan_inputs(card, torch.float32, 1, 40, 2, 16, seed=8)
    r.requires_grad_(True)
    s0 = torch.zeros(1, 2, 16, 16, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="initial state"):
        rwkv6_wkv(r, k, v, logw, u, state=s0, out_dtype=torch.float32)
    out, s_fin = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="final state"):
        (out.sum() + s_fin.sum()).backward()


def test_backward_kernels_raise_rather_than_fall_back(card, monkeypatch):
    """A backward library that does not load propagates its error out of
    loss.backward(): no plain gradient is computed in its place."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops

    def broken():
        raise OSError("backward library missing")

    monkeypatch.setattr(flash_ops, "_bwd_library", broken)
    monkeypatch.setattr(scan_ops, "_bwd_library", broken)
    q = torch.randn(1, 16, 2, 64, device=card, requires_grad=True)
    with pytest.raises(OSError, match="backward library missing"):
        flash_ops.flash_attention_bshd(q, q.detach(), q.detach()).sum().backward()
    r, k, v, logw, u, _ = _scan_inputs(card, torch.float32, 1, 40, 2, 16, seed=10)
    r.requires_grad_(True)
    out, _ = scan_ops.rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
    with pytest.raises(OSError, match="backward library missing"):
        out.sum().backward()


def test_inference_forward_writes_no_lse(card):
    """Without a gradient the forward runs without FlashAttention's saved
    state: no autograd graph, one forward launch."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    q = torch.randn(1, 64, 2, 64, device=card, requires_grad=True)
    with torch.no_grad():
        o = flash_attention_bshd(q, q, q)
    assert o.grad_fn is None
    o = flash_attention_bshd(q, q, q)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b", "recurrentgemma_2b", "whisper_tiny"])
def test_training_gradients_on_card_match_plain(card, arch):
    """At smoke size in float32, the kernel path's loss and every gradient
    against the plain path's (1e-4 per tensor), with the launches the
    design implies: per checkpointed block, each forward kernel twice (the
    forward and its recompute) and each backward kernel once; Whisper's
    decoder is not rematerialised, as in the reference."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).smoke()
    params = models.init(cfg, torch.Generator(device=card).manual_seed(0), card)
    g = torch.Generator(device=card).manual_seed(1)
    s = cfg.local_window or 40  # recurrentgemma: S = W, so its attention is causal and takes flash
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=g, device=card),
             "labels": torch.randint(-1, cfg.vocab_size, (2, s), generator=g, device=card)}
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.randn(2, cfg.enc_seq_len, cfg.d_model, generator=g, device=card)
    kernels.reset_launches()
    loss, got = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    fwd, bwd = ("rwkv6_scan", "rwkv6_scan_bwd") if cfg.family == "ssm" else ("flash_attention", "flash_attention_bwd")
    n = cfg.n_layers if cfg.family in ("ssm", "audio") else cfg.layer_kinds().count("attn")
    remat = 1 if cfg.family == "audio" else 2
    assert (kernels.LAUNCHES[fwd], kernels.LAUNCHES[bwd]) == (remat * n, n)
    want_loss, want = loss_and_grads(cfg, params, batch, use_kernel=False)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for k, w in want.items():
        if w.norm() > 0:
            assert _l2_rel(got[k], w) <= 1e-4, k
