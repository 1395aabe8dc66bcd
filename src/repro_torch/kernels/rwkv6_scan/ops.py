"""Wrapper of the chunked RWKV6 WKV scan (``rwkv6_scan.cu``) in the
model's [B, T, H, N] layout.

On a CUDA tensor it launches the hand-written kernel (a chunk kernel, then
a state kernel, on the current stream; the float32 scratch between them is
allocated here), or raises: it never falls back to the plain version.  The plain version (``ref.py``) runs only
for real tensors that lie on the CPU (a fake one takes the kernel path,
below), or when the caller asks for it with
``use_kernel=False``; autograd through it is the plain version of the
backward.  When a gradient is needed (grad mode on and r, k, v, logw, u or
the initial state requiring one), the kernel runs inside ``RWKV6Scan``, an
autograd Function whose backward launches ``rwkv6_scan_bwd.cu`` (counted
as ``rwkv6_scan_bwd``, variant ``chunk16/32/64`` by head dim): it takes
the gradient that reaches the final state and returns the initial
state's.

Each launch is a ``torch.library`` custom op (``repro_torch::rwkv6_scan_fwd``
and ``..._bwd``) with a fake implementation and a flop formula, as flash's
(see ``kernels/flash_attention/ops.py``).  Under a mesh (DTensor operands)
the wrapper runs the kernel on each rank's local shard by the rule of
``kernels/sharded.py``: r, k, v, logw [B,T,H,N] share placements, batch
(dim 0) or heads (dim 2) sharded; u [H,N] follows the heads or replicates,
and the initial state [B,H,N,N] follows both.
"""
from __future__ import annotations

from typing import Optional

import ctypes
import functools
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import count_launch
from ..build import load_library
from ..sharded import from_local_like, is_dtensor, is_fake, local_kv_heads, mesh_plan
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
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rwkv6_scan_bwd_work_floats.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_bwd_work_floats.restype = ctypes.c_int
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
    if any(is_dtensor(a) for a in (r, k, v, logw, u, state)):
        return _sharded(r, k, v, logw, u, state, out_dtype, use_kernel)
    if not use_kernel or (r.device.type == "cpu" and not is_fake(r)):
        return _plain(r, k, v, logw, u, state, out_dtype)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in (r, k, v, logw, u, state)):
        return RWKV6Scan.apply(r, k, v, logw, u, state, out_dtype)
    return _launch(r, k, v, logw, u, state, out_dtype)


class RWKV6Scan(torch.autograd.Function):
    """The kernel with its gradient with respect to r, k, v, logw, u and
    the initial state: the forward saves its inputs; the backward launches
    the backward kernel on the gradients of the output and of the final
    state (or raises: it has no plain fallback)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, out_dtype):
        out, s_fin = _launch(r, k, v, logw, u, state, out_dtype)
        ctx.save_for_backward(r, k, v, logw, u, state)
        ctx.set_materialize_grads(False)
        return out, s_fin

    @staticmethod
    def backward(ctx, dout, ds_fin):
        r, k, v, logw, u, state = ctx.saved_tensors
        if dout is None and ds_fin is None:
            return (None,) * 7
        dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device) if dout is None else dout.contiguous()
        ds_fin = None if ds_fin is None else ds_fin.contiguous()
        dr, dk, dv, dlogw, du, ds0 = _launch_bwd(r, k, v, logw, u, state, dout, ds_fin, with_ds0=ctx.needs_input_grad[5])
        return dr, dk, dv, dlogw, du, ds0, None


def _sharded(r, k, v, logw, u, state, out_dtype, use_kernel):
    """The wrapper on each rank's shard of DTensor operands (see the module
    docstring): (wkv laid out as r, final state [B,H,N,N] with r's batch
    and head placements)."""
    others = {"k": (k, 0, 2), "v": (v, 0, 2), "logw": (logw, 0, 2), "u": (u, None, 0), "state": (state, 0, 1)}
    plan = mesh_plan("the rwkv6 scan", r, others, batch_dim=0, head_dim=2)
    if any(plan.select[n] for n in ("k", "v", "logw")):
        raise ValueError(f"the rwkv6 scan under a mesh: k, v, logw must share r's placements {r.placements}")
    local = {n: t.to_local(grad_placements=plan.grad[n]) for n, (t, _, _) in others.items() if t is not None}
    h = r.shape[2]
    for n, dim in (("u", 0), ("state", 1)):
        if plan.select.get(n):
            lo, hi = local_kv_heads(h, h, plan.head_parts, plan.head_index)
            local[n] = local[n].narrow(dim, lo, hi - lo).contiguous()
    out, s_fin = rwkv6_wkv(r.to_local(), local["k"], local["v"], local["logw"], local["u"], state=local.get("state"),
                           out_dtype=out_dtype, use_kernel=use_kernel)
    b, t, _, n = r.shape
    return from_local_like(out, r), from_local_like(s_fin, r, dims=(0, None, 1, None), shape=(b, h, n, n))


def _plain(r, k, v, logw, u, state, out_dtype):
    b, t, h, n = r.shape
    to_bh = lambda a: a.transpose(1, 2).reshape(b * h, t, n)
    s0 = None if state is None else state.reshape(b * h, n, n)
    o, s = rwkv6_scan_ref(to_bh(r), to_bh(k), to_bh(v), to_bh(logw), u.repeat(b, 1), s0, out_dtype=out_dtype)
    return o.reshape(b, h, t, n).transpose(1, 2), s.reshape(b, h, n, n)


def _check(r, k, v, logw, u, state):
    dev = r.device
    tensors = (r, k, v, logw, u) + (() if state is None else (state,))
    if (dev.type != "cuda" and not is_fake(r)) or any(a.device != dev for a in tensors):
        raise ValueError(f"rwkv6_scan kernel needs every operand on one CUDA device, got {[str(a.device) for a in tensors]}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan kernel takes r, k, v in float32 or bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(a.dtype != torch.float32 for a in tensors[3:]):
        raise TypeError("rwkv6_scan kernel takes logw, u and state in float32")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("rwkv6_scan kernel needs contiguous operands")
    if r.shape[3] not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes head dims {HEAD_DIMS}, got {r.shape[3]}")


def _launch(r, k, v, logw, u, state, out_dtype, split=None):
    """The kernel; ``split`` forces a variant (state CTAs per head) where
    tests and chip_smoke.py hold every one against the plain version."""
    _check(r, k, v, logw, u, state)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"rwkv6_scan kernel writes float32 or bfloat16, not {out_dtype}")
    return torch.ops.repro_torch.rwkv6_scan_fwd(r, k, v, logw, u, state, out_dtype, split or 0)


@torch.library.custom_op("repro_torch::rwkv6_scan_fwd", mutates_args=())
def _fwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
            state: Optional[torch.Tensor], out_dtype: torch.dtype, split: int) -> tuple[torch.Tensor, torch.Tensor]:
    if any(a.data_ptr() % 16 for a in (r, k, v, logw)):
        raise ValueError("rwkv6_scan kernel reads r, k, v, logw in 16-byte pieces: they must be 16-byte aligned")
    dev = r.device
    b, t, h, n = r.shape
    out = torch.empty(r.shape, dtype=out_dtype, device=dev)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    if not split:
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
    count_launch("rwkv6_scan", f"split{split}", (b, t, h, n))
    return out, s_fin


@_fwd_op.register_fake
def _(r, k, v, logw, u, state, out_dtype, split):
    b, t, h, n = r.shape
    return r.new_empty(r.shape, dtype=out_dtype), r.new_empty((b, h, n, n), dtype=torch.float32)


def _launch_bwd(r, k, v, logw, u, state, dout, ds_fin=None, *, with_ds0=False):
    """The backward kernel: (dr, dk, dv in r's dtype, dlogw float32
    [B,T,H,N], du float32 [H,N], dS0 float32 [B,H,N,N] or None) from the
    forward's inputs, the wkv output's gradient ``dout`` (float32 or
    bfloat16) and the final state's, ``ds_fin`` (float32 [B,H,N,N], or
    None for zeros); dS0, the initial state's gradient, when ``with_ds0``."""
    _check(r, k, v, logw, u, state)
    if dout.shape != r.shape or dout.dtype not in _DTYPE_CODE or dout.device != r.device or not dout.is_contiguous():
        raise ValueError(f"rwkv6_scan backward needs dout contiguous, float32 or bfloat16, shaped as r "
                         f"{tuple(r.shape)}; got {tuple(dout.shape)} {dout.dtype} on {dout.device}")
    dev = r.device
    b, t, h, n = r.shape
    if ds_fin is not None and (tuple(ds_fin.shape) != (b, h, n, n) or ds_fin.dtype != torch.float32
                               or ds_fin.device != dev or not ds_fin.is_contiguous()):
        raise ValueError(f"rwkv6_scan backward needs ds_fin contiguous float32 [B,H,N,N] = {(b, h, n, n)} on {dev}; "
                         f"got {tuple(ds_fin.shape)} {ds_fin.dtype} on {ds_fin.device}")
    dr, dk, dv, dlogw, du, ds0 = torch.ops.repro_torch.rwkv6_scan_bwd(r, k, v, logw, u, state, dout, ds_fin, with_ds0)
    return dr, dk, dv, dlogw, du, ds0 if with_ds0 else None


@torch.library.custom_op("repro_torch::rwkv6_scan_bwd", mutates_args=())
def _bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
            state: Optional[torch.Tensor], dout: torch.Tensor, ds_fin: Optional[torch.Tensor],
            with_ds0: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    if dout.data_ptr() % 16:
        raise ValueError("rwkv6_scan backward reads dout in 16-byte pieces: it must be 16-byte aligned")
    dev = r.device
    b, t, h, n = r.shape
    lib = _bwd_library()
    nc = -(-t // CHUNK)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dlogw = torch.empty(r.shape, dtype=torch.float32, device=dev)
    du_part = torch.empty((b, h, nc, n), dtype=torch.float32, device=dev)  # per chunk
    # per (batch, head, chunk): the increments of S and G, then the walk's states
    work = torch.empty(b * h * nc * lib.rwkv6_scan_bwd_work_floats(n), dtype=torch.float32, device=dev)
    ds0 = torch.empty((b, h, n, n) if with_ds0 else (0,), dtype=torch.float32, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rwkv6_scan_bwd_launch(
        _DTYPE_CODE[r.dtype], _DTYPE_CODE[dout.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), ptr(state), dout.data_ptr(), ptr(ds_fin), work.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlogw.data_ptr(), du_part.data_ptr(), ds0.data_ptr() if with_ds0 else None, b, t, h, n, stream,
    )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan backward kernel launch failed: cudaError {err} (B={b}, T={t}, H={h}, N={n})")
    count_launch("rwkv6_scan_bwd", f"chunk{n}", (b, t, h, n))
    return dr, dk, dv, dlogw, du_part.sum((0, 2)), ds0


@_bwd_op.register_fake
def _(r, k, v, logw, u, state, dout, ds_fin, with_ds0):
    b, t, h, n = r.shape
    f32 = torch.float32
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v), r.new_empty(r.shape, dtype=f32),
            r.new_empty((h, n), dtype=f32), r.new_empty((b, h, n, n) if with_ds0 else (0,), dtype=f32))


def fwd_flops(b: int, t: int, h: int, n: int) -> float:
    """The chunked algorithm's operations: per chunk of ``CHUNK`` tokens and
    head, the carry-in r S and the increment k^T v (2 c N^2 each), the
    intra-chunk pairs and the bonus (``chip_smoke.py`` counts the same)."""
    c = CHUNK
    per_chunk = 4 * c * n * n + n * n + 3 * n * c * (c - 1) / 2 + 3 * n * c + 2 * n * c * (c + 1) / 2 + 4 * c * n
    return float(b * h * -(-t // c) * per_chunk)


def bwd_flops(b: int, t: int, h: int, n: int) -> float:
    """12 N^2 per token and head: five products of 2 N^2 and dlogw's."""
    return 12.0 * b * t * h * n * n


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_fwd)
def _(r_shape, *args, **kwargs) -> float:
    return fwd_flops(*r_shape)


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_bwd)
def _(r_shape, *args, **kwargs) -> float:
    return bwd_flops(*r_shape)
