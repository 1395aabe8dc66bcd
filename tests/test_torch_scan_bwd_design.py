"""The arithmetic of the port's RWKV6 scan backward (``rwkv6_scan_bwd.cu``),
emulated in float32 PyTorch on the CPU and held against autograd through
the stepwise recurrence in float64, and the port's ``time_mix`` state
gradients against the reference's ``jax.grad``.

The emulation follows the three kernels step by step:

* the chunk kernel: per chunk of 32, the sub-chunk-of-8 decay sums of the
  forward (``scan.cuh``; every exponent a direct sum over its own range),
  the increments dS = k_dec^T v and dG = r_dec^T do and exp(L_C);
* the walk: S forward from s0, G backward from dS_fin, one element-wise
  update per chunk; G at the start of chunk 0 is dS0;
* the gradient kernel, per chunk: D = do v^T; inside each sub-chunk of 8
  the pairs on the CUDA cores, each weight exp of a running sum; across
  sub-chunks and from the chunk's boundary states, split-TF32 products
  (hi rounded to nearest, lo truncated by the tensor core); dlogw as the
  sum over exactly the pairs (s, q), s < t < q, that span each token t.

Beside it, the form the design avoids: dlogw as the difference of
sequence-wide reverse cumulative sums of r dr and k dk, which at the
model's strongest decays returns rounding at the scale of dr where the
true gradient is 0.

Tolerances: the emulation within 1e-6 of the float64 oracle per tensor
(||got - want|| / ||want||; read up to 1.6e-7: float32 work); the model
test uses ``tests/test_torch_train_grads.py``'s limit for rwkv6, 1e-4 per
tensor (the reference's chunked scan takes its exponents as differences
of cumulative sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as j_rwkv6
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.models import rwkv6
from repro_torch.models.common import Registry
from test_torch_scan_design import C, SUB, mma, seg_exclusive, seg_scan, tf32_hi

EMU_TOL = 1e-6
MODEL_TOL = 1e-4  # tests/test_torch_train_grads.py, rwkv6
NAMES = ("r", "k", "v", "logw", "u", "s0")


# ------------------------------------------------------------------ emulation
def decays(x):
    """The sub-chunk-of-8 factoring of one chunk's log-decays x [bh, C, N]:
    exp of the exclusive prefix and suffix inside each sub-chunk, and the
    runs of whole sub-chunks: before sub-chunk a, after it, between two,
    the whole chunk."""
    sinc, ssuf = seg_scan(x), seg_scan(x, reverse=True)
    sP, sQ = seg_exclusive(sinc), seg_exclusive(ssuf, reverse=True)
    T = [sinc[:, SUB * a + SUB - 1] for a in range(4)]
    e = torch.exp
    before = {0: None, 1: e(T[0]), 2: e(T[0] + T[1]), 3: e((T[0] + T[1]) + T[2])}
    after = {0: e((T[1] + T[2]) + T[3]), 1: e(T[2] + T[3]), 2: e(T[3]), 3: None}
    between = {(0, 1): None, (1, 2): None, (2, 3): None, (0, 2): e(T[1]), (1, 3): e(T[2]), (0, 3): e(T[1] + T[2])}
    return e(sP), e(sQ), before, after, between, e(((T[0] + T[1]) + T[2]) + T[3])


def by_sub(a, f):
    """a [bh, C, N] times f[sub-chunk] [bh, N] row by row (None: 1)."""
    out = a.clone()
    for s in range(4):
        if f[s] is not None:
            out[:, SUB * s:SUB * s + SUB] = a[:, SUB * s:SUB * s + SUB] * f[s][:, None]
    return out


def chunk_kernel(r, k, v, do, x, v_exact, do_exact):
    """dS = k_dec^T v, dG = r_dec^T do, exp(L_C) of one chunk."""
    eSP, eSQ, before, after, _, wc = decays(x)
    rdec, kdec = by_sub(r * eSP, before), by_sub(k * eSQ, after)
    bh, _, n = r.shape
    ds = mma(torch.zeros(bh, n, n), kdec.transpose(1, 2), v, v_exact)
    dg = mma(torch.zeros(bh, n, n), rdec.transpose(1, 2), do, do_exact)
    return ds, dg, wc


def grad_kernel(r, k, v, do, x, u, S, G, v_exact, do_exact):
    """dr, dk, dv, dlogw and the du share of one chunk from its start state
    S and the gradient G that reaches its end."""
    bh, _, n = r.shape
    eSP, eSQ, before, after, between, wc = decays(x)
    ar, bk = r * eSP, k * eSQ
    D = mma(torch.zeros(bh, C, C), do, v.transpose(1, 2), v_exact)
    ti = torch.arange(C)
    Dtt = D[:, ti, ti]
    # pairs inside each sub-chunk, CUDA cores: weight exp of the running sum of
    # logw over (s, t), s = t - d
    drD, dkD, span = (torch.zeros(bh, C, n) for _ in range(3))
    sc = torch.zeros(bh, C, C)
    sc[:, ti, ti] = (r * k * u[:, None, :]).sum(-1)
    E = []
    acc = torch.zeros_like(x)
    for d in range(1, SUB):
        ok = (ti % SUB >= d)
        ksh, dsh = torch.zeros_like(k), torch.zeros(bh, C)
        ksh[:, d:] = k[:, :-d]
        dsh[:, d:] = D[:, ti[d:], ti[d:] - d]
        A = torch.exp(acc) * ok[:, None]
        ep = dsh[:, :, None] * A
        drD += ep * ksh
        er = ep * r
        dkD[:, :-d] += er[:, d:] * (ok[d:])[:, None]
        E.append(ep * r * ksh)
        t_ok = ti[ok]
        sc[:, t_ok, t_ok - d] = (r * ksh * A).sum(-1)[:, ok]
        xsh = torch.zeros_like(x)
        xsh[:, d:] = x[:, :-d]
        acc = acc + xsh
    # span_t: pairs (t + delta, s), s < t, inside the sub-chunk; E[d - 1] holds
    # the pair (t, t - d) at row t
    H = [None] * SUB
    H[SUB - 2] = E[SUB - 2]
    for delta in range(SUB - 3, 0, -1):
        H[delta] = E[delta] + H[delta + 1]
    for delta in range(1, SUB - 1):
        ok = (ti % SUB + delta < SUB)[:-delta]
        span[:, :-delta] += H[delta][:, delta:] * ok[:, None]
    # the six score blocks across sub-chunks, as the forward's
    for a in range(1, 4):
        for b in range(a):
            rows, cols = slice(SUB * a, SUB * a + SUB), slice(SUB * b, SUB * b + SUB)
            f = between[(b, a)][:, None, :] if between[(b, a)] is not None else 1.0
            sc[:, rows, cols] = mma(torch.zeros(bh, SUB, SUB), ar[:, rows] * f, bk[:, cols].transpose(1, 2))
    # products from the boundary states
    xr = mma(torch.zeros(bh, n, C), S, do.transpose(1, 2), do_exact).transpose(1, 2)  # do S^T
    yk = mma(torch.zeros(bh, n, C), G, v.transpose(1, 2), v_exact).transpose(1, 2)    # v G^T
    kdec = by_sub(bk, after)
    dv = mma(mma(torch.zeros(bh, C, n), kdec, G), sc.transpose(1, 2), do, do_exact)
    # across sub-chunks: Z(a) = D[8a:, :8a] K(a), K(a)_s = bk_s * between(sub(s), a);
    # V(b) = D[8(b+1):, b]^T R(b), R(b)_q = ar_q * between(b, sub(q))
    Z = {}
    zr, vc = torch.zeros(bh, C, n), torch.zeros(bh, C, n)
    for a in range(1, 4):
        Ka = bk[:, :SUB * a].clone()
        for b in range(a):
            if between[(b, a)] is not None:
                Ka[:, SUB * b:SUB * b + SUB] *= between[(b, a)][:, None]
        Z[a] = mma(torch.zeros(bh, n, C - SUB * a), Ka.transpose(1, 2),
                   D[:, SUB * a:, :SUB * a].transpose(1, 2)).transpose(1, 2)
        zr[:, SUB * a:SUB * a + SUB] = Z[a][:, :SUB]
    for b in range(3):
        Rb = ar[:, SUB * (b + 1):].clone()
        for a in range(b + 1, 4):
            if between[(b, a)] is not None:
                Rb[:, SUB * (a - b - 1):SUB * (a - b)] *= between[(b, a)][:, None]
        vc[:, SUB * b:SUB * b + SUB] = mma(torch.zeros(bh, n, SUB), Rb.transpose(1, 2),
                                           D[:, SUB * (b + 1):, SUB * b:SUB * b + SUB]).transpose(1, 2)
    eP, eQ = by_sub(eSP, before), by_sub(eSQ, after)
    drI, dkI, drX, dkX = eP * xr, eQ * yk, eSP * zr, eSQ * vc
    dr = drI + drX + drD + u[:, None] * k * Dtt[:, :, None]
    dk = dkI + dkX + dkD + u[:, None] * r * Dtt[:, :, None]
    # dlogw: every pair that spans t, each with its own decay
    rho_i, kap_i, rho_x, kap_x = r * drI, k * dkI, r * drX, k * dkX
    suffix = lambda a, width: sum_excl(a, width, reverse=True)
    prefix = lambda a, width: sum_excl(a, width, reverse=False)
    omega = torch.zeros(bh, C, n)
    # Omega_a: pairs from before sub-chunk a to after it (Z rows past a's own 8)
    omega[:, SUB:2 * SUB] = ((ar[:, 2 * SUB:3 * SUB] * between[(0, 2)][:, None] * Z[1][:, SUB:2 * SUB]).sum(1)
                             + (ar[:, 3 * SUB:] * between[(0, 3)][:, None] * Z[1][:, 2 * SUB:]).sum(1))[:, None]
    omega[:, 2 * SUB:3 * SUB] = (ar[:, 3 * SUB:] * between[(1, 3)][:, None] * Z[2][:, SUB:]).sum(1)[:, None]
    c1 = (S * G).sum(-1)
    dlogw = (wc * c1)[:, None] + suffix(rho_i, C) + prefix(kap_i, C) + omega + suffix(rho_x, SUB) \
        + prefix(kap_x, SUB) + span
    du = (r * k * Dtt[:, :, None]).sum(1)
    return dr, dk, dv, dlogw, du


def sum_excl(a, width, reverse):
    """Exclusive sums along tokens inside segments of ``width``: of the
    tokens after t (reverse) or before t."""
    out = torch.zeros_like(a)
    for s0 in range(0, a.shape[1], width):
        seg = a[:, s0:s0 + width]
        if reverse:
            out[:, s0:s0 + width - 1] = seg[:, 1:].flip(1).cumsum(1).flip(1)
        else:
            out[:, s0 + 1:s0 + width] = seg[:, :-1].cumsum(1)
    return out


def emulate_bwd(r, k, v, logw, u, s0, dout, ds_fin):
    """The backward kernels' arithmetic: (dr, dk, dv, dlogw, du, dS0).
    r, k, v, logw, dout: [BH, T, N] float32 (r, k, v, dout may hold bf16
    values); u [BH, N]; s0, ds_fin [BH, N, N] or None."""
    bh, t, n = r.shape
    v_exact = bool(torch.equal(tf32_hi(v), v))
    do_exact = bool(torch.equal(tf32_hi(dout), dout))
    pad = (-t) % C
    f = lambda a: torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
    r, k, v, logw, do = f(r), f(k), f(v), f(logw), f(dout)
    nc = (t + pad) // C
    sl = lambda a, c: a[:, C * c:C * c + C]
    inc = [chunk_kernel(sl(r, c), sl(k, c), sl(v, c), sl(do, c), sl(logw, c), v_exact, do_exact) for c in range(nc)]
    S = [torch.zeros(bh, n, n) if s0 is None else s0.float().clone()]
    for ds, _, wc in inc[:-1]:
        S.append(wc[:, :, None] * S[-1] + ds)
    G = [None] * nc
    g = torch.zeros(bh, n, n) if ds_fin is None else ds_fin.float().clone()
    for c in range(nc - 1, -1, -1):
        G[c] = g
        g = inc[c][2][:, :, None] * g + inc[c][1]
    outs = [grad_kernel(sl(r, c), sl(k, c), sl(v, c), sl(do, c), sl(logw, c), u.float(), S[c], G[c], v_exact,
                        do_exact) for c in range(nc)]
    dr, dk, dv, dlogw = (torch.cat([o[i] for o in outs], 1)[:, :t] for i in range(4))
    du = sum(o[4] for o in outs)
    return dr, dk, dv, dlogw, du, g


def oracle(r, k, v, logw, u, s0, dout, ds_fin):
    """Autograd through the stepwise ``rwkv6_scan_ref`` in float64 of
    sum(out * dout) + sum(s_fin * ds_fin)."""
    leaves = [a.double().requires_grad_(True) for a in (r, k, v, logw, u, s0)]
    out, s_fin = rwkv6_scan_ref(*leaves)
    loss = (out * dout.double()).sum() + (0.0 if ds_fin is None else (s_fin * ds_fin.double()).sum())
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def difference_form_dlogw(r, k, v, logw, u, dr, dk, dout):
    """dlogw as the difference of sequence-wide reverse cumulative sums of
    r (dr - bonus) and k (dk - bonus), in float32 (no boundary state)."""
    vdo = (v * dout).sum(-1, keepdim=True)
    rho, kap = r * (dr - u[:, None] * k * vdo), k * (dk - u[:, None] * r * vdo)
    rev = lambda a: a.flip(1).cumsum(1).flip(1)
    return (rev(rho) - rho) - rev(kap)


# ------------------------------------------------------------------ inputs
def inputs(pattern, bh, t, n, seed):
    """r, k (0.5 N(0,1)), v (N(0,1)) and dout (N(0,1)) rounded to bf16 values,
    u, s0, dS_fin, and a log-decay: ``mild`` -exp(U[-8, 0]); ``strong``
    -exp(U[3, 6]) (to the model's clip of e^6); ``mixed`` -exp(U[-8, 6]);
    ``strong4`` -e^6 for the first 4 steps of every chunk of 32, then -1e-3."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float()
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    r, k = (bf(0.5 * rng.standard_normal((bh, t, n))) for _ in range(2))
    v, dout = (bf(rng.standard_normal((bh, t, n))) for _ in range(2))
    u = f32(0.1 * rng.standard_normal((bh, n)))
    s0, ds_fin = (f32(0.1 * rng.standard_normal((bh, n, n))) for _ in range(2))
    lo, hi = {"mild": (-8.0, 0.0), "strong": (3.0, 6.0), "mixed": (-8.0, 6.0), "strong4": (0.0, 0.0)}[pattern]
    lw = -np.exp(rng.uniform(lo, hi, (bh, t, n)))
    if pattern == "strong4":
        lw = np.full((bh, t, n), -1e-3)
        for c0 in range(0, t, C):
            lw[:, c0:c0 + 4] = -np.exp(6.0)
    return r, k, v, f32(lw), u, s0, dout, ds_fin


def l2_rel(got, want, scale_if_zero=0.0):
    got = got.double()
    norm = 0.0 if want is None else want.double().norm().item()
    diff = got.norm() if norm == 0 else (got - want.double()).norm()
    return (diff / max(norm or scale_if_zero, 1e-300)).item()


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("pattern", ["mild", "strong", "mixed", "strong4"])
@pytest.mark.parametrize("n,t", [(16, 45), (32, 96), (64, 70)])
def test_design_matches_float64_autograd(pattern, n, t):
    """All seven gradients -- r, k, v, logw, u, the initial state, and the
    loss's share through the final state -- ragged T over two to three
    chunks, against autograd through the recurrence in float64."""
    r, k, v, lw, u, s0, do, dsf = inputs(pattern, 2, t, n, seed=n + t)
    got = emulate_bwd(r, k, v, lw, u, s0, do, dsf)
    want = oracle(r, k, v, lw, u, s0, do, dsf)
    scale = do.double().norm().item()
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == (w.shape if w is not None else g.shape)
        assert l2_rel(g, w, scale) <= EMU_TOL, (name, l2_rel(g, w, scale))


@pytest.mark.parametrize("with_state", [False, True])
def test_design_at_one_token(with_state):
    """T = 1: one ragged chunk; dlogw then reaches only the final state."""
    r, k, v, lw, u, s0, do, dsf = inputs("mixed", 3, 1, 16, seed=1)
    s0 = s0 if with_state else None
    got = emulate_bwd(r, k, v, lw, u, s0, do, dsf)
    want = oracle(r, k, v, lw, u, torch.zeros(3, 16, 16) if s0 is None else s0, do, dsf)
    for name, g, w in zip(NAMES, got, want):
        assert l2_rel(g, w, do.double().norm().item()) <= EMU_TOL, name


def test_design_without_final_state_gradient():
    """dS_fin absent: the walk of G starts from zeros, as the training path
    (which drops the final state) gives it."""
    r, k, v, lw, u, s0, do, _ = inputs("mixed", 2, 100, 32, seed=4)
    got = emulate_bwd(r, k, v, lw, u, s0, do, None)
    want = oracle(r, k, v, lw, u, s0, do, None)
    for name, g, w in zip(NAMES, got, want):
        assert l2_rel(g, w) <= EMU_TOL, name


def test_dlogw_spanning_sums_hold_where_the_difference_form_fails():
    """At log-decays of -e^5.5 and below, w underflows and the true dlogw of
    such a token is below 1e-100.  The spanning sums give 0 there (every
    term carries that token's w); the difference of reverse cumulative sums
    returns rounding at the scale of dr (read 3.8e-6 against a largest |dr|
    of 27), more than 1e-8 of it."""
    r, k, v, lw, u, _, do, _ = inputs("strong", 2, 96, 32, seed=5)
    dr, dk, _, dlogw, _, _ = emulate_bwd(r, k, v, lw, u, None, do, None)
    want = oracle(r, k, v, lw, u, torch.zeros(2, 32, 32), do, None)[3]
    strong = lw < -np.exp(5.5)
    assert strong.sum() > 100 and want[strong].abs().max() < 1e-100
    scale = dr.abs().max().item()
    assert dlogw[strong].abs().max().item() <= 1e-30
    old = difference_form_dlogw(r, k, v, lw, u, dr, dk, do)
    assert (old.double() - want)[strong].abs().max().item() > 1e-8 * scale


# ------------------------------------------------- the model against the reference
def time_mix_inputs(d=64, h=4, n=16, t=45, seed=0):
    """time_mix parameters (the port's shapes and scales, w0 = 0, u random),
    x, a carried state and x_last, and weights of the loss on s_fin, numpy."""
    reg = Registry(torch.Generator().manual_seed(seed), torch.device("cpu"))
    rwkv6.time_mix_params(reg, "tm", d, h, n)
    p = {key[3:]: val.numpy() for key, val in reg.params.items()}
    rng = np.random.default_rng(seed)
    p["u"] = (0.1 * rng.standard_normal((h, n))).astype(np.float32)
    p["mu_w"] = (0.5 * rng.random(d)).astype(np.float32)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    state = (0.1 * rng.standard_normal((2, h, n, n))).astype(np.float32)
    x_last = rng.standard_normal((2, d)).astype(np.float32)
    ws = rng.standard_normal((2, h, n, n)).astype(np.float32)
    return p, x, state, x_last, ws


@pytest.mark.parametrize("t", [45, 1])
def test_time_mix_state_gradients_match_reference(t):
    """The port's ``time_mix`` (on the CPU: autograd through the plain scan)
    against ``jax.grad`` of the reference's, with a carried initial state
    that takes a gradient and a loss on out and on s_fin: every parameter,
    x, x_last and the state, per tensor."""
    h, n = 4, 16
    p, x, state, x_last, ws = time_mix_inputs(t=t)

    def j_loss(p, x, state, x_last):
        out, (s_fin, _) = j_rwkv6.time_mix(p, x, h, n, state=state, x_last=x_last)
        return (out ** 2).sum() + (s_fin * ws).sum()

    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3))({k: jnp.asarray(v) for k, v in p.items()}, *(jnp.asarray(a) for a in (x, state, x_last)))
    want = {**{k: np.asarray(v) for k, v in jg[0].items()}, "x": jg[1], "state": jg[2], "x_last": jg[3]}
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx, ts, tl = (torch.from_numpy(a).requires_grad_(True) for a in (x, state, x_last))
    out, (s_fin, _) = rwkv6.time_mix(tp, tx, h, n, state=ts, x_last=tl)
    ((out ** 2).sum() + (s_fin * torch.from_numpy(ws)).sum()).backward()
    got = {**{k: v.grad for k, v in tp.items()}, "x": tx.grad, "state": ts.grad, "x_last": tl.grad}
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.zeros_like(w) if got[key] is None else got[key].double().numpy()
        norm = np.linalg.norm(w)
        if norm == 0:  # a parameter the loss does not reach (mu_x)
            assert not g.any(), key
            continue
        assert np.linalg.norm(g - w) <= MODEL_TOL * norm, (key, np.linalg.norm(g - w) / norm)


if __name__ == "__main__":
    # the readings the tests hold, printed: python tests/test_torch_scan_bwd_design.py
    for pattern in ("mild", "strong", "mixed", "strong4"):
        for n, t in ((16, 45), (32, 96), (64, 70)):
            r, k, v, lw, u, s0, do, dsf = inputs(pattern, 2, t, n, seed=n + t)
            got = emulate_bwd(r, k, v, lw, u, s0, do, dsf)
            want = oracle(r, k, v, lw, u, s0, do, dsf)
            errs = {nm: l2_rel(g, w, do.double().norm().item()) for nm, g, w in zip(NAMES, got, want)}
            print(pattern, n, t, " ".join(f"{nm} {e:.2e}" for nm, e in errs.items()))
