"""The arithmetic of the port's RWKV6 scan kernel (``rwkv6_scan.cu``),
emulated in float32 PyTorch on the CPU and held against the stepwise
recurrence and the reference's Pallas kernel.

The emulation follows the kernel step by step: lane-per-token scans inside
sub-chunks of 8, every exponent a direct sum over its own range (the
chunk-wide prefix and suffix as products of a sub-chunk part and a run of
whole sub-chunks), the off-diagonal score blocks as factored products, the
split-TF32 tensor-core products (hi rounded to nearest, lo truncated by the
tensor core), and the state walked by value-column slices.  The form that
the TPU kernel and the port's first CUDA kernel share -- exponents as
differences of chunk-wide cumulative sums -- is emulated beside it, to show
the cancellation the redesign removes.

Tolerance: 2e-4 relative to the largest |value|, the reference's own
(``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.kernel import rwkv6_scan as j_scan
from repro_torch.kernels.rwkv6_scan.ops import variant
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

C, SUB = 32, 8
SCAN_TOL = 2e-4


# ------------------------------------------------------------------ emulation
def tf32_hi(x):
    """The kernel's tf32_hi: round to TF32 (10 mantissa bits) to nearest."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mma(acc, a, b, b_exact=False):
    """acc + a @ b as the kernel's split-TF32 passes: lo*hi, hi*lo, hi*hi."""
    ah, bh = tf32_hi(a), (b if b_exact else tf32_hi(b))
    acc = acc + tf32_trunc(a - ah) @ bh
    if not b_exact:
        acc = acc + ah @ tf32_trunc(b - bh)
    return acc + ah @ bh


def seg_scan(x, reverse=False):
    """Inclusive Hillis-Steele scan along the token axis (-2) within each
    sub-chunk of 8, as the kernel's width-8 shuffles do."""
    if reverse:
        x = x.flip(-2)
    pos = torch.arange(x.shape[-2]) % SUB
    y, d = x.clone(), 1
    while d < SUB:
        sh = torch.zeros_like(y)
        sh[..., d:, :] = y[..., :-d, :]
        y = torch.where((pos >= d)[:, None], y + sh, y)
        d *= 2
    return y.flip(-2) if reverse else y


def seg_exclusive(inc, reverse=False):
    """The neighbour's inclusive sum (zero at the sub-chunk's edge)."""
    if reverse:
        inc = inc.flip(-2)
    pos = torch.arange(inc.shape[-2]) % SUB
    sh = torch.zeros_like(inc)
    sh[..., 1:, :] = inc[..., :-1, :]
    y = torch.where((pos >= 1)[:, None], sh, torch.zeros_like(sh))
    return y.flip(-2) if reverse else y


def chunk_products(rc, kc, vc, x, u, v_exact):
    """The chunk kernel: r_dec, intra (+ bonus), dS = k_dec^T v, exp(L_C)."""
    bh, _, n = rc.shape
    sinc, ssuf = seg_scan(x), seg_scan(x, reverse=True)
    sP, sQ = seg_exclusive(sinc), seg_exclusive(ssuf, reverse=True)
    T = [sinc[:, SUB * a + SUB - 1] for a in range(4)]  # whole sub-chunks, [bh, n]
    before = {1: T[0], 2: T[0] + T[1], 3: (T[0] + T[1]) + T[2]}
    after = {0: (T[1] + T[2]) + T[3], 1: T[2] + T[3], 2: T[3]}
    whole = ((T[0] + T[1]) + T[2]) + T[3]
    between = {(0, 2): T[1], (1, 3): T[2], (0, 3): T[1] + T[2]}
    ar, bk = rc * torch.exp(sP), kc * torch.exp(sQ)
    rd, kd = ar.clone(), bk.clone()
    for a in range(4):
        rows = slice(SUB * a, SUB * a + SUB)
        if a > 0:
            rd[:, rows] = ar[:, rows] * torch.exp(before[a])[:, None]
        if a < 3:
            kd[:, rows] = bk[:, rows] * torch.exp(after[a])[:, None]
    sc = torch.zeros(bh, C, C)
    # diagonal sub-blocks: exp of the running sum over (i, t); d = 0 the bonus
    ti = torch.arange(C)
    sc[:, ti, ti] = (rc * kc * u[:, None, :]).sum(-1)
    acc = torch.zeros_like(x)
    for d in range(1, SUB):
        ksh = torch.zeros_like(kc)
        ksh[:, d:] = kc[:, :-d]
        ok = ti % SUB >= d
        w = (rc * ksh * torch.exp(acc)).sum(-1)  # [bh, C]
        t_ok = ti[ok]
        sc[:, t_ok, t_ok - d] = w[:, ok]
        xsh = torch.zeros_like(x)
        xsh[:, d:] = x[:, :-d]
        acc = acc + xsh
    # the six blocks below them: factored, on the tensor cores (3 passes)
    for a in range(1, 4):
        for b in range(a):
            rows, cols = slice(SUB * a, SUB * a + SUB), slice(SUB * b, SUB * b + SUB)
            f = torch.exp(between[(b, a)])[:, None, :] if a - b > 1 else 1.0
            sc[:, rows, cols] = mma(torch.zeros(bh, SUB, SUB), ar[:, rows] * f, bk[:, cols].transpose(1, 2))
    intra = mma(torch.zeros(bh, C, n), sc, vc, v_exact)
    ds = mma(torch.zeros(bh, n, n), kd.transpose(1, 2), vc, v_exact)
    return rd, intra, ds, torch.exp(whole)


def emulate_scan(r, k, v, logw, u, state=None, split=4):
    """The two kernels' arithmetic.  r, k, v, logw: [BH, T, N] float32 (r, k,
    v may hold bf16 values); u: [BH, N]; state: [BH, N, N] or None.  The state
    walks in ``split`` slices of value columns, as the state CTAs do."""
    bh, t, n = r.shape
    v_exact = bool(torch.equal(tf32_hi(v), v))  # bf16 values are TF32 values
    pad = (-t) % C
    f = lambda a: torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
    r, k, v, logw = f(r), f(k), f(v), f(logw)
    S = torch.zeros(bh, n, n) if state is None else state.float().clone()
    out = torch.empty(bh, t + pad, n)
    q = n // split
    for c0 in range(0, t + pad, C):
        rd, intra, ds, wc = chunk_products(*(a[:, c0:c0 + C] for a in (r, k, v, logw)), u.float(), v_exact)
        for j in range(split):
            cols = slice(q * j, q * (j + 1))
            out[:, c0:c0 + C, cols] = intra[:, :, cols] + mma(torch.zeros(bh, C, q), rd, S[:, :, cols])
            S[:, :, cols] = wc[:, :, None] * S[:, :, cols] + ds[:, :, cols]
    return out[:, :t], S


def cumsum_difference_form(r, k, v, logw, u):
    """The TPU kernel's chunk body, as the port's first CUDA kernel ran it:
    a sequential float32 cumulative sum L per chunk, every exponent a
    difference of two of its values."""
    bh, t, n = r.shape
    S = torch.zeros(bh, n, n)
    out = torch.empty(bh, t, n)
    mask = torch.tril(torch.ones(C, C), -1)
    for c0 in range(0, t, C):
        rc, kc, vc, x = (a[:, c0:c0 + C].float() for a in (r, k, v, logw))
        L = torch.empty_like(x)
        acc = torch.zeros_like(x[:, 0])
        for i in range(C):  # one float32 add per step, as the kernel's loop
            acc = acc + x[:, i]
            L[:, i] = acc
        Lp = L - x
        A = torch.exp(torch.clamp(Lp[:, :, None] - L[:, None], -60.0, 0.0))
        sc = torch.einsum("btn,bin,btin->bti", rc, kc, A) * mask
        sc = sc + torch.diag_embed((rc * kc * u[:, None]).sum(-1))
        out[:, c0:c0 + C] = (rc * torch.exp(Lp)) @ S + sc @ vc
        S = S * torch.exp(L[:, -1])[:, :, None] + (kc * torch.exp(L[:, -1:] - L)).transpose(1, 2) @ vc
    return out, S


def stepwise64(r, k, v, logw, u, state=None):
    """The recurrence in float64."""
    r, k, v, logw, u = (np.asarray(a, np.float64) for a in (r, k, v, logw, u))
    bh, t, n = r.shape
    S = np.zeros((bh, n, n)) if state is None else np.asarray(state, np.float64).copy()
    out = np.empty((bh, t, n))
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        out[:, i] = np.einsum("bn,bnm->bm", r[:, i], S + u[:, :, None] * kv)
        S = S * np.exp(logw[:, i])[:, :, None] + kv
    return out, S


# ------------------------------------------------------------------ inputs
def inputs(pattern, bh, t, n, seed):
    """r, k (0.5 N(0,1)), v (N(0,1)) rounded to bf16 values, u, s0 and a
    log-decay: ``random`` per element -exp(U[-8, 6]) (the model's clip);
    ``strong16`` / ``strong4`` -e^6 for the first 16 / 4 steps of every
    chunk of 32, then -1e-3."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float()
    r, k = (bf(0.5 * rng.standard_normal((bh, t, n))) for _ in range(2))
    v = bf(rng.standard_normal((bh, t, n)))
    u = torch.from_numpy((0.1 * rng.standard_normal((bh, n))).astype(np.float32))
    s0 = torch.from_numpy((0.1 * rng.standard_normal((bh, n, n))).astype(np.float32))
    if pattern == "random":
        lw = -np.exp(rng.uniform(-8.0, 6.0, (bh, t, n)))
    else:
        strong = int(pattern[6:])
        lw = np.full((bh, t, n), -1e-3)
        for c0 in range(0, t, C):
            lw[:, c0:c0 + strong] = -np.exp(6.0)
    return r, k, v, torch.from_numpy(lw.astype(np.float32)), u, s0


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


PATTERNS = ["random", "strong16", "strong4"]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n,t", [(16, 45), (64, 70)])
def test_design_matches_stepwise_ref(pattern, n, t):
    """Ragged T, a carried state: the emulated kernel against the port's
    stepwise ``rwkv6_scan_ref``, outputs and final state."""
    r, k, v, lw, u, s0 = inputs(pattern, 2, t, n, seed=n + t)
    got, s_got = emulate_scan(r, k, v, lw, u, s0, split=n // 16)
    want, s_want = rwkv6_scan_ref(r, k, v, lw, u, s0)
    assert rel(got, want) <= SCAN_TOL
    assert rel(s_got, s_want) <= SCAN_TOL


@pytest.mark.parametrize("pattern", PATTERNS)
def test_design_matches_pallas(pattern):
    """The emulated kernel against the reference's Pallas kernel in
    interpret mode, T a multiple of its chunk, no initial state, both
    measured from the float64 recurrence.  The design sits within 1e-6 of
    it; the Pallas kernel keeps the cumulative-sum differences, so on the
    strong-then-weak patterns it is off by its own cancellation (2.4e-4 here
    at strong16).  The two agree to 2e-4, or to within the Pallas kernel's
    own distance from the recurrence where that is larger."""
    r, k, v, lw, u, _ = inputs(pattern, 2, 64, 32, seed=7)
    got, _ = emulate_scan(r, k, v, lw, u, split=2)
    want = np.asarray(j_scan(*(jnp.asarray(a.numpy()) for a in (r, k, v, lw, u)), chunk=32, interpret=True))
    truth, _ = stepwise64(r, k, v, lw, u)
    e_design, e_pallas = rel(got, truth), rel(want, truth)
    assert e_design < 1e-6
    assert rel(got, want) <= max(SCAN_TOL, 1.05 * e_pallas)
    if pattern == "random":
        assert rel(got, want) <= SCAN_TOL


def test_cumsum_difference_form_fails_where_direct_sums_hold():
    """-e^6 for 4 steps, then -1e-3 for 28, in every chunk: the
    cumulative sum reaches ~1.6e3 and the weak steps' small exponents lose
    ~1e-4 each as differences of it.  The chunk-wide difference form reads
    above the 2e-4 limit against the float64 recurrence; the direct sums stay
    below 1e-6."""
    r, k, v, lw, u, _ = inputs("strong4", 4, 64, 64, seed=0)
    want, _ = stepwise64(r, k, v, lw, u)
    old, _ = cumsum_difference_form(r, k, v, lw, u)
    new, _ = emulate_scan(r, k, v, lw, u)
    assert rel(old, want) > SCAN_TOL
    assert rel(new, want) < 1e-6


@pytest.mark.parametrize("pattern", ["random", "strong16"])
def test_design_tracks_float64_recurrence(pattern):
    """Direct sums and split-TF32 products keep float32 accuracy: the
    emulated kernel within 1e-6 of the float64 recurrence, state included."""
    r, k, v, lw, u, s0 = inputs(pattern, 2, 96, 64, seed=3)
    want, s_want = stepwise64(r, k, v, lw, u, s0)
    got, s_got = emulate_scan(r, k, v, lw, u, s0)
    assert rel(got, want) < 1e-6
    assert rel(s_got, s_want) < 1e-6


def test_weights_below_e60_are_not_clipped():
    """Where the TPU kernel lifts a weight below e^-60 to e^-60, the kernel
    keeps the true one, as the recurrence does: with logw = -31 per step,
    pairs two apart weigh e^-31, three apart e^-62, not e^-60.  The bonus is
    off and only k_0 and v_0 are non-zero, so out_t = r_t k_0 weight(t, 0) v_0."""
    n, t = 16, 32
    r = torch.ones(1, t, n)
    k = torch.zeros(1, t, n)
    k[0, 0] = 1.0
    v = torch.zeros(1, t, n)
    v[0, 0, 0] = 1.0
    lw = torch.full((1, t, n), -31.0)
    u = torch.zeros(1, n)
    got, _ = emulate_scan(r, k, v, lw, u, split=1)
    for d, want in ((1, float(n)), (2, n * np.exp(-31.0)), (3, n * np.exp(-62.0))):
        assert got[0, d, 0].item() == pytest.approx(want, rel=1e-5, abs=0.0)
    assert got[0, 3, 0].item() < n * np.exp(-60.0) / 5  # not the clipped e^-60


def test_value_splits_agree():
    """The state walked in 1, 2 or 4 slices of value columns is the same
    computation: columns of S never mix."""
    r, k, v, lw, u, s0 = inputs("random", 2, 40, 64, seed=11)
    outs = [emulate_scan(r, k, v, lw, u, s0, split=s) for s in (1, 2, 4)]
    for o, s in outs[1:]:
        assert torch.equal(o, outs[0][0]) and torch.equal(s, outs[0][1])


@pytest.mark.parametrize("head_dim,heads,want", [
    (64, 40, "split4"),    # rwkv6_3b, B=1: 160 state CTAs
    (64, 160, "split2"),   # B=4: 320, not 640
    (64, 320, "split1"),   # B=8
    (32, 40, "split2"),    # at most head_dim / 16
    (16, 40, "split1"),
])
def test_variant_picks_the_split_by_grid(head_dim, heads, want):
    assert variant(head_dim, heads, 132) == want


if __name__ == "__main__":
    # the readings the tests hold, printed: python tests/test_torch_scan_design.py
    r, k, v, lw, u, _ = inputs("strong4", 4, 64, 64, seed=0)
    truth, _ = stepwise64(r, k, v, lw, u)
    print(f"strong4, T=64, N=64, vs the float64 recurrence: cumulative-sum differences "
          f"{rel(cumsum_difference_form(r, k, v, lw, u)[0], truth):.2e}, direct sums {rel(emulate_scan(r, k, v, lw, u)[0], truth):.2e}")
    for pattern in PATTERNS:
        r, k, v, lw, u, _ = inputs(pattern, 2, 64, 32, seed=7)
        truth, _ = stepwise64(r, k, v, lw, u)
        want = np.asarray(j_scan(*(jnp.asarray(a.numpy()) for a in (r, k, v, lw, u)), chunk=32, interpret=True))
        print(f"{pattern}, T=64, N=32, vs the float64 recurrence: Pallas kernel {rel(want, truth):.2e}, "
              f"design {rel(emulate_scan(r, k, v, lw, u, split=2)[0], truth):.2e}")
