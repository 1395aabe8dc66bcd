"""Wrapper of causal flash attention (``flash_attention.cu``) in the
models' [B, S, H, D] layout with grouped KV heads, and of its backward
(``flash_attention_bwd.cu``).

On a CUDA tensor it launches the hand-written kernel, or raises: it never
falls back to the plain version.  The plain version (``ref.py``) runs only
for tensors that lie on the CPU, or when the caller asks for it with
``use_kernel=False``; autograd through it is the plain version of the
backward.  When a gradient is needed (grad mode on and q, k or v requiring
one), the kernel runs inside ``FlashAttention``, an autograd Function whose
forward also writes the row log-sum-exp and whose backward launches the
backward kernel (counted as ``flash_attention_bwd``); without one, the
forward writes the output alone.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import count_launch
from ..build import load_library
from .ref import flash_attention_ref

SOURCE = Path(__file__).with_name("flash_attention.cu")
BWD_SOURCE = Path(__file__).with_name("flash_attention_bwd.cu")
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 256
VARIANTS = ("flash_simple", "flash_mma", "flash_wgmma")  # the launcher's variant codes 0, 1, 2


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that a launch of (dtype, head_dim) takes: ``flash_wgmma``
    (TMA, warp-specialised wgmma) for bfloat16 with D in {64, 128};
    ``flash_mma`` (mma.sync) for other bfloat16 with D % 16 == 0;
    ``flash_simple`` (CUDA cores) for float32 and the remaining D."""
    if dtype == torch.bfloat16 and head_dim in (64, 128):
        return "flash_wgmma"
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "flash_mma"
    return "flash_simple"


BWD_VARIANTS = ("bwd_simple", "bwd_mma")  # the backward launcher's variant codes 0, 1


def bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels that a launch takes: ``bwd_mma`` (mma.sync) for
    bfloat16 with D % 16 == 0 and D <= 128; ``bwd_simple`` (CUDA cores) for
    float32 and the rest."""
    return "bwd_mma" if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= 128 else "bwd_simple"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_library(BWD_SOURCE)
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_bshd(q, k, v, *, use_kernel: bool = True, kind: str | None = None) -> torch.Tensor:
    """Causal attention. q: [B,S,H,D]; k,v: [B,S,Hkv,D] with H % Hkv == 0
    (query head h reads KV head h // (H // Hkv)); -> [B,S,H,D] in q's
    dtype, with scale 1/sqrt(D).  ``kind`` forces one of ``VARIANTS`` in
    place of ``variant(dtype, D)``'s choice (to time one variant against
    another); the launcher refuses a variant that cannot take the shape."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"need q [B,S,H,D] and k, v [B,S,Hkv,D]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % hkv != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if kind is not None and kind not in VARIANTS:
        raise ValueError(f"kind must be one of {VARIANTS}, got {kind!r}")
    if not use_kernel or q.device.type == "cpu":
        return _plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, kind)
    return _launch(q, k, v, kind)[0]


class FlashAttention(torch.autograd.Function):
    """The kernel with its gradient: the forward saves q, k, v, the output
    and the row log-sum-exp; the backward launches the backward kernel on
    them (or raises: it has no plain fallback)."""

    @staticmethod
    def forward(ctx, q, k, v, kind):
        out, lse = _launch(q, k, v, kind, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout.contiguous())
        return dq, dk, dv, None


def _plain(q, k, v):
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    to_bh = lambda a: a.transpose(1, 2).reshape(b * h, s, d)
    o = flash_attention_ref(to_bh(q), to_bh(k), to_bh(v))
    return o.reshape(b, h, s, d).transpose(1, 2)


def _check(q, k, v):
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, got {dev}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims up to {MAX_HEAD_DIM}, got {q.shape[3]}")


def _launch(q, k, v, kind=None, with_lse: bool = False):
    """The forward kernel: (output, row log-sum-exp float32 [B, H, S] when
    ``with_lse``, else None)."""
    _check(q, k, v)
    dev = q.device
    b, s, h, d = q.shape
    kind = kind or variant(q.dtype, d)
    if kind == "flash_wgmma" and any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("flash_wgmma reads q, k, v through TMA and needs them 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) if with_lse else None
    if out.numel() == 0:
        return out, lse
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().flash_attention_launch(
        _DTYPE_CODE[q.dtype], VARIANTS.index(kind), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, k.shape[2], d, 1.0 / d**0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel {kind} launch failed: cudaError {err} "
                           f"(B={b}, S={s}, H={h}, Hkv={k.shape[2]}, D={d})")
    count_launch("flash_attention", kind)
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout):
    """The backward kernel: (dq, dk, dv) in q's dtype from the forward's
    q, k, v, output and row log-sum-exp and the output's gradient."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention backward needs out and dout shaped and typed as q {tuple(q.shape)} "
                         f"{q.dtype}; got {tuple(out.shape)} {out.dtype}, {tuple(dout.shape)} {dout.dtype}")
    b, s, h, d = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_attention backward needs lse float32 [B, H, S]; got {lse.dtype} {tuple(lse.shape)}")
    if not (out.is_contiguous() and dout.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention backward needs contiguous out, dout and lse")
    if any(a.device != q.device for a in (out, lse, dout)):
        raise ValueError("flash_attention backward needs every operand on q's device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    kind = bwd_variant(q.dtype, d)
    if kind == "bwd_mma" and any(a.data_ptr() % 16 for a in (q, k, v, out, dout)):
        raise ValueError("flash_attention backward bwd_mma moves q, k, v, out, dout in 16-byte pieces and needs "
                         "them 16-byte aligned")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_library().flash_attention_bwd_launch(
        _DTYPE_CODE[q.dtype], BWD_VARIANTS.index(kind), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], d,
        1.0 / d**0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel {kind} launch failed: cudaError {err} "
                           f"(B={b}, S={s}, H={h}, Hkv={k.shape[2]}, D={d})")
    count_launch("flash_attention_bwd", kind)
    return dq, dk, dv
