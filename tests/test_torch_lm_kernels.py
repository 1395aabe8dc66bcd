"""The port's flash-attention and RWKV6-scan plain versions and wrappers,
held against the reference's Pallas kernels (interpret mode on the CPU)
and oracles on the same numpy inputs.

Tolerances are those of the reference's own kernel tests
(``tests/test_kernels.py``): 2e-5 for flash attention in float32 and 2e-4
for the scan, whose chunked and stepwise forms sum in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ops import flash_attention_bshd as j_flash_bshd
from repro.kernels.rwkv6_scan.kernel import rwkv6_scan as j_scan
from repro.kernels.rwkv6_scan.ops import rwkv6_wkv as j_wkv
from repro_torch import kernels
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.kernels.flash_attention.ops import bwd_variant as flash_bwd_variant
from repro_torch.kernels.flash_attention.ops import variant as flash_variant
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

FLASH_TOL = 2e-5
SCAN_TOL = 2e-4


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def scan_inputs(rng, lead, n, logw_scale=0.5):
    """r, k, v, logw of shape lead + (n,) as the reference's scan tests draw
    them: logw = -exp(N(0, logw_scale))."""
    r = normal(rng, *lead, n, scale=0.5)
    k = normal(rng, *lead, n, scale=0.5)
    v = normal(rng, *lead, n)
    logw = -np.exp(normal(rng, *lead, n, scale=logw_scale))
    return r, k, v, logw


T = torch.from_numpy


@pytest.mark.parametrize("bh,s,d,blk", [(2, 64, 32, 32), (3, 128, 64, 64), (1, 96, 16, 32)])
def test_flash_plain_matches_pallas(bh, s, d, blk):
    rng = np.random.default_rng(s + d)
    q, k, v = (normal(rng, bh, s, d) for _ in range(3))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=blk, bk=blk, interpret=True)
    got = flash_attention_ref(T(q), T(k), T(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 128, 8, 2, 48),   # GQA, d=48 (the reference pads it to 128 lanes)
    (1, 37, 4, 4, 16),    # S that no tile divides
    (2, 64, 4, 1, 64),    # one KV head for all query heads
])
def test_flash_wrapper_matches_reference_wrapper(b, s, h, hkv, d):
    rng = np.random.default_rng(b * s + d)
    q = normal(rng, b, s, h, d)
    k, v = normal(rng, b, s, hkv, d), normal(rng, b, s, hkv, d)
    blk = 64 if s % 64 == 0 else s
    want = j_flash_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=blk, bk=blk, interpret=True)
    before = dict(kernels.LAUNCHES)
    got = flash_attention_bshd(T(q), T(k), T(v))
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "flash_wgmma"),   # llama3_8b's heads
    (torch.bfloat16, 64, "flash_wgmma"),
    (torch.bfloat16, 96, "flash_mma"),
    (torch.bfloat16, 16, "flash_mma"),
    (torch.bfloat16, 256, "flash_wgmma"),   # recurrentgemma_2b's heads
    (torch.bfloat16, 160, "flash_wgmma"),   # pixtral_12b's heads
    (torch.bfloat16, 48 + 1, "flash_simple"),
    (torch.float32, 128, "flash_simple"),
    (torch.float32, 64, "flash_simple"),
])
def test_flash_dispatch(dtype, d, want):
    """The launcher picks its kernel from (dtype, D) before any launch."""
    assert flash_variant(dtype, d) == want


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "bwd_wgmma"),   # llama3_8b's heads
    (torch.bfloat16, 64, "bwd_wgmma"),
    (torch.bfloat16, 16, "bwd_mma"),
    (torch.bfloat16, 96, "bwd_mma"),
    (torch.bfloat16, 160, "bwd_wgmma"),   # pixtral_12b's heads
    (torch.bfloat16, 256, "bwd_wgmma"),   # recurrentgemma_2b's heads
    (torch.bfloat16, 192, "bwd_simple"),
    (torch.float32, 128, "bwd_simple"),
    (torch.float32, 64, "bwd_simple"),
    (torch.float32, 256, "bwd_simple"),
])
def test_flash_bwd_dispatch(dtype, d, want):
    """The backward launcher picks its kernels from (dtype, D) before any
    launch."""
    assert flash_bwd_variant(dtype, d) == want


@pytest.mark.parametrize("shape,sms,want", [
    ((2, 2048, 10, 1, 256), 132, 5),   # recurrentgemma_2b's training shape: 64 -> 320 dK/dV CTAs
    ((2, 2048, 32, 8, 160), 132, 1),   # pixtral_12b's: 512 CTAs already
    ((2, 2048, 32, 8, 128), 132, 1),   # D 128's dK/dV kernel takes no split
    ((1, 150, 4, 1, 256), 132, 4),     # too few CTAs at any split: the whole group
    ((2, 2048, 10, 1, 256), 16, 1),    # a small card: 64 CTAs are enough
])
def test_flash_bwd_splits(shape, sms, want):
    """bwd_wgmma at D 160 / 256 splits a KV group's query heads over dK/dV
    CTAs by a divisor of H / Hkv, the least that gives two CTAs per SM."""
    from repro_torch.kernels.flash_attention.ops import bwd_splits

    b, s, h, hkv, d = shape
    n = bwd_splits(b, s, h, hkv, d, sms)
    assert n == want and (h // hkv) % n == 0


def test_kernel_library_is_named_by_its_headers_too(tmp_path):
    """A source's library is rebuilt when a header beside it changes: the
    flash sources share hopper.cuh."""
    from repro_torch.kernels.build import library_path

    src, header = tmp_path / "k.cu", tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("// one\n")
    first = library_path(src)
    header.write_text("// two\n")
    assert library_path(src) != first and library_path(src).name.startswith("k-")


def test_flash_plain_is_strictly_causal():
    """Future keys and values must not change earlier outputs."""
    rng = np.random.default_rng(2)
    q, k, v = (T(normal(rng, 1, 128, 64)) for _ in range(3))
    o1 = flash_attention_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:] = 99.0
    v2[:, 64:] = -99.0
    o2 = flash_attention_ref(q, k2, v2)
    torch.testing.assert_close(o1[:, :64], o2[:, :64], rtol=1e-6, atol=0)


def test_flash_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))  # 4 % 3 != 0
    with pytest.raises(ValueError):
        flash_attention_bshd(q, torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16))


def test_flash_wrapper_rejects_an_unknown_kind():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, q, q, kind="flash_fast")
    torch.testing.assert_close(flash_attention_bshd(q, q, q, kind="flash_mma"), flash_attention_bshd(q, q, q))


@pytest.mark.parametrize("t,chunk", [(64, 16), (32, 32), (48, 8)])
def test_scan_plain_matches_pallas(t, chunk):
    rng = np.random.default_rng(t + chunk)
    r, k, v, logw = scan_inputs(rng, (2, t), 16)
    u = normal(rng, 2, 16, scale=0.1)
    want = j_scan(*(jnp.asarray(a) for a in (r, k, v, logw, u)), chunk=chunk, interpret=True)
    got, _ = rwkv6_scan_ref(T(r), T(k), T(v), T(logw), T(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("t,logw_scale", [(45, 0.5), (33, 3.0)])
def test_scan_wrapper_matches_reference_wrapper(t, logw_scale):
    """T not a multiple of the chunk (the reference pads it with logw=0);
    logw_scale=3 reaches decays past the clip at -60 within a chunk."""
    rng = np.random.default_rng(t)
    b, h, n = 2, 3, 16
    r, k, v, logw = scan_inputs(rng, (b, t, h), n, logw_scale)
    logw = np.maximum(logw, -np.exp(6.0)).astype(np.float32)  # the model's clip
    u = normal(rng, h, n, scale=0.1)
    want = j_wkv(*(jnp.asarray(a) for a in (r, k, v, logw, u)), chunk=16, interpret=True)
    got, s_fin = rwkv6_wkv(T(r), T(k), T(v), T(logw), T(u))
    assert got.shape == (b, t, h, n) and s_fin.shape == (b, h, n, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_scan_out_dtype(out_dtype):
    """``out_dtype`` sets the type of the wkv output (r's by default); the
    sums are float32 whatever it is, so a float32 output of bf16 inputs is
    the float32 scan of the same bf16 values, and the state is float32."""
    rng = np.random.default_rng(11)
    r, k, v, logw = (T(a) for a in scan_inputs(rng, (2, 21, 2), 16))
    u = T(normal(rng, 2, 16, scale=0.1))
    rb, kb, vb = (a.to(torch.bfloat16) for a in (r, k, v))
    got, s = rwkv6_wkv(rb, kb, vb, logw, u, out_dtype=out_dtype)
    want, s_want = rwkv6_wkv(rb.float(), kb.float(), vb.float(), logw, u)
    assert got.dtype == (torch.bfloat16 if out_dtype is None else out_dtype) and s.dtype == torch.float32
    torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=0)
    torch.testing.assert_close(s, s_want, rtol=0, atol=0)


def test_scan_state_carries_across_calls():
    """Scanning T1 then T2 tokens from the first call's state equals one
    scan of T1 + T2 tokens, outputs and final state alike."""
    rng = np.random.default_rng(7)
    b, h, n = 1, 2, 16
    r, k, v, logw = (T(a) for a in scan_inputs(rng, (b, 40, h), n))
    u = T(normal(rng, h, n, scale=0.1))
    whole, s_whole = rwkv6_wkv(r, k, v, logw, u)
    first, s1 = rwkv6_wkv(r[:, :17], k[:, :17], v[:, :17], logw[:, :17], u)
    second, s2 = rwkv6_wkv(r[:, 17:], k[:, 17:], v[:, 17:], logw[:, 17:], u, state=s1)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s2, s_whole, rtol=1e-5, atol=1e-6)


def test_scan_wrapper_rejects_mismatched_shapes():
    a = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        rwkv6_wkv(a, a, a, a, torch.zeros(3, 16))
    with pytest.raises(ValueError):
        rwkv6_wkv(a, a, a[:, :3], a, torch.zeros(2, 16))
