"""Wrapper of the chunked RWKV6 WKV scan (``rwkv6_scan.cu``) in the
model's [B, T, H, N] layout.

On a CUDA tensor it launches the hand-written kernel (a chunk kernel, then
a state kernel, on the current stream; the float32 scratch between them is
allocated here), or raises: it never falls back to the plain version.  The plain version (``ref.py``) runs only
for tensors that lie on the CPU, or when the caller asks for it with
``use_kernel=False``; autograd through it is the plain version of the
backward.  When a gradient is needed (grad mode on and r, k, v, logw or u
requiring one), the kernel runs inside ``RWKV6Scan``, an autograd Function
whose backward launches ``rwkv6_scan_bwd.cu`` (counted as
``rwkv6_scan_bwd``).  The training path starts from a zero state and drops
the final state: an initial state that needs a gradient, or a gradient that
reaches the final state, is refused, not silently dropped.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import count_launch
from ..build import load_library
from .ref import rwkv6_scan_ref

SOURCE = Path(__file__).with_name("rwkv6_scan.cu")
BWD_SOURCE = Path(__file__).with_name("rwkv6_scan_bwd.cu")
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64)
CHUNK = 32  # tokens per chunk, as in the kernel


def variant(head_dim: int, heads: int, sms: int) -> str:
    """The state kernel that a launch over ``heads`` (batch x heads) of
    ``head_dim`` takes on a card of ``sms`` SMs, named by how many CTAs
    split each head's value columns: the most, up to head_dim / 16, that
    keep the grid within about three CTAs per SM.  More CTAs per head fill
    the card when heads are few; fewer read the chunk's shared r_dec fewer
    times when they are many (rwkv6_3b: split4 at B=1, split2 at B=4;
    PERF.md)."""
    split = head_dim // 16
    while split > 1 and heads * split > 3 * sms:
        split //= 2
    return f"split{split}"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.rwkv6_scan_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    fn.restype = ctypes.c_int
    lib.rwkv6_scan_work_floats.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_work_floats.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_library(BWD_SOURCE)
    fn = lib.rwkv6_scan_bwd_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rwkv6_scan_bwd_row_blocks.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_bwd_row_blocks.restype = ctypes.c_int
    return lib


def rwkv6_wkv(r, k, v, logw, u, *, state=None, out_dtype=None, use_kernel: bool = True):
    """r,k,v,logw: [B,T,H,N]; u: [H,N]; state: [B,H,N,N] or None (zeros).
    Returns (wkv output [B,T,H,N] in ``out_dtype``, by default r's dtype,
    final state [B,H,N,N] float32)."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"r, k, v, logw must share one [B,T,H,N] shape, got {[tuple(a.shape) for a in (r, k, v, logw)]}")
    b, t, h, n = r.shape
    if tuple(u.shape) != (h, n) or (state is not None and tuple(state.shape) != (b, h, n, n)):
        raise ValueError(f"u must be [H,N] = {(h, n)} and state [B,H,N,N]; got {tuple(u.shape)}, "
                         f"{None if state is None else tuple(state.shape)}")
    out_dtype = r.dtype if out_dtype is None else out_dtype
    if not use_kernel or r.device.type == "cpu":
        return _plain(r, k, v, logw, u, state, out_dtype)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (r, k, v, logw, u)):
        if state is not None and state.requires_grad:
            raise ValueError("rwkv6_scan kernel: the initial state receives no gradient (the training path starts "
                             "from zeros); detach it, or take the plain version with use_kernel=False")
        return RWKV6Scan.apply(r, k, v, logw, u, state, out_dtype)
    return _launch(r, k, v, logw, u, state, out_dtype)


class RWKV6Scan(torch.autograd.Function):
    """The kernel with its gradient with respect to r, k, v, logw and u: the
    forward saves its inputs; the backward launches the backward kernel (or
    raises: it has no plain fallback)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, out_dtype):
        out, s_fin = _launch(r, k, v, logw, u, state, out_dtype)
        ctx.save_for_backward(r, k, v, logw, u, state)
        ctx.set_materialize_grads(False)
        return out, s_fin

    @staticmethod
    def backward(ctx, dout, ds_fin):
        if ds_fin is not None:
            raise RuntimeError("rwkv6_scan kernel: a gradient reached the final state, which its backward does not "
                               "take (the training path drops it); use use_kernel=False for such a loss")
        r, k, v, logw, u, state = ctx.saved_tensors
        if dout is None:
            return (None,) * 7
        dr, dk, dv, dlogw, du = _launch_bwd(r, k, v, logw, u, state, dout.contiguous())
        return dr, dk, dv, dlogw, du, None, None


def _plain(r, k, v, logw, u, state, out_dtype):
    b, t, h, n = r.shape
    to_bh = lambda a: a.transpose(1, 2).reshape(b * h, t, n)
    s0 = None if state is None else state.reshape(b * h, n, n)
    o, s = rwkv6_scan_ref(to_bh(r), to_bh(k), to_bh(v), to_bh(logw), u.repeat(b, 1), s0, out_dtype=out_dtype)
    return o.reshape(b, h, t, n).transpose(1, 2), s.reshape(b, h, n, n)


def _check(r, k, v, logw, u, state):
    dev = r.device
    tensors = (r, k, v, logw, u) + (() if state is None else (state,))
    if dev.type != "cuda" or any(a.device != dev for a in tensors):
        raise ValueError(f"rwkv6_scan kernel needs every operand on one CUDA device, got {[str(a.device) for a in tensors]}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan kernel takes r, k, v in float32 or bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(a.dtype != torch.float32 for a in tensors[3:]):
        raise TypeError("rwkv6_scan kernel takes logw, u and state in float32")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("rwkv6_scan kernel needs contiguous operands")
    if any(a.data_ptr() % 16 for a in (r, k, v, logw)):
        raise ValueError("rwkv6_scan kernel reads r, k, v, logw in 16-byte pieces: they must be 16-byte aligned")
    if r.shape[3] not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes head dims {HEAD_DIMS}, got {r.shape[3]}")


def _launch(r, k, v, logw, u, state, out_dtype, split=None):
    """The kernel; ``split`` forces a variant (state CTAs per head) where
    tests and chip_smoke.py hold every one against the plain version."""
    _check(r, k, v, logw, u, state)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"rwkv6_scan kernel writes float32 or bfloat16, not {out_dtype}")
    dev = r.device
    b, t, h, n = r.shape
    out = torch.empty(r.shape, dtype=out_dtype, device=dev)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    if split is None:
        split = int(variant(n, b * h, torch.cuda.get_device_properties(dev).multi_processor_count)[len("split"):])
    lib = _library()
    # per (batch, head, chunk): the chunk kernel's products, which the state kernel reads
    work = torch.empty(b * h * (-(-t // CHUNK)) * lib.rwkv6_scan_work_floats(n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rwkv6_scan_launch(
        _DTYPE_CODE[r.dtype], _DTYPE_CODE[out_dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), s_fin.data_ptr(), out.data_ptr(), b, t, h, n, stream,
        work.data_ptr(), split,
    )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError {err} (B={b}, T={t}, H={h}, N={n})")
    count_launch("rwkv6_scan", f"split{split}")
    return out, s_fin


def _launch_bwd(r, k, v, logw, u, state, dout):
    """The backward kernel: (dr, dk, dv in r's dtype, dlogw float32
    [B,T,H,N], du float32 [H,N]) from the forward's inputs and the wkv
    output's gradient ``dout`` (float32 or bfloat16)."""
    _check(r, k, v, logw, u, state)
    if dout.shape != r.shape or dout.dtype not in _DTYPE_CODE or dout.device != r.device or not dout.is_contiguous():
        raise ValueError(f"rwkv6_scan backward needs dout contiguous, float32 or bfloat16, shaped as r "
                         f"{tuple(r.shape)}; got {tuple(dout.shape)} {dout.dtype} on {dout.device}")
    dev = r.device
    b, t, h, n = r.shape
    lib = _bwd_library()
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dlogw = torch.empty(r.shape, dtype=torch.float32, device=dev)
    du_part = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    ckpt = torch.empty((b * h, -(-t // CHUNK), n, n), dtype=torch.float32, device=dev)  # each chunk's start state
    dv_part = torch.empty((lib.rwkv6_scan_bwd_row_blocks(n),) + tuple(r.shape), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rwkv6_scan_bwd_launch(
        _DTYPE_CODE[r.dtype], _DTYPE_CODE[dout.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(), dout.data_ptr(), ckpt.data_ptr(),
        dv_part.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du_part.data_ptr(),
        b, t, h, n, stream,
    )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan backward kernel launch failed: cudaError {err} (B={b}, T={t}, H={h}, N={n})")
    count_launch("rwkv6_scan_bwd", f"n{n}")
    return dr, dk, dv, dlogw, du_part.sum(0)
