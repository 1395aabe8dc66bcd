"""Wrapper of causal flash attention (``flash_attention.cu``) in the
models' [B, S, H, D] layout with grouped KV heads, and of its backward
(``flash_attention_bwd.cu``).

On a CUDA tensor it launches the hand-written kernel, or raises: it never
falls back to the plain version.  The plain version (``ref.py``) runs only
for real tensors that lie on the CPU (a fake one takes the kernel path,
below), or when the caller asks for it with
``use_kernel=False``; autograd through it is the plain version of the
backward.  When a gradient is needed (grad mode on and q, k or v requiring
one), the kernel runs inside ``FlashAttention``, an autograd Function whose
forward also writes the row log-sum-exp and whose backward launches the
backward kernel (counted as ``flash_attention_bwd``); without one, the
forward writes the output alone.

Each launch is a ``torch.library`` custom op (``repro_torch::flash_attention_fwd``
and ``..._bwd``): its real implementation launches the kernel; its fake
one gives shapes and dtypes only, so that a step on fake tensors (the dry
run, ``launch/costs.py``) goes through the kernel path without launching
anything, and a flop formula counts it there (causal: 2 B H S^2 D forward,
2.5 times that backward).

Under a mesh (q, k, v DTensors) the wrapper runs the kernel on each rank's
local shard: the batch (dim 0) may be sharded on any mesh dims, the heads
(dim 2) on one, and every other mesh dim replicates.  k and v follow q, or
replicate their heads where q shards them (GQA with ``Hkv`` not divisible
by the mesh dim), and then each rank takes the KV heads that its query
heads read (``local_kv_heads``).  Any other placement raises: nothing
gathers a sharded input to run the kernel on the whole.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import count_launch
from ..build import load_library
from ..sharded import heads_local, is_dtensor, is_fake
from .ref import flash_attention_ref

SOURCE = Path(__file__).with_name("flash_attention.cu")
BWD_SOURCE = Path(__file__).with_name("flash_attention_bwd.cu")
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 256
VARIANTS = ("flash_simple", "flash_mma", "flash_wgmma")  # the launcher's variant codes 0, 1, 2


WGMMA_HEAD_DIMS = (64, 128, 160, 256)  # flash_wgmma's instantiations


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that a launch of (dtype, head_dim) takes: ``flash_wgmma``
    (TMA, warp-specialised wgmma) for bfloat16 with D in {64, 128} (key
    tiles of 128) and {160, 256} (key tiles of 64; D = 160 as three
    64-column panels); ``flash_mma`` (mma.sync) for other bfloat16 with D %
    16 == 0; ``flash_simple`` (CUDA cores) for float32 and the remaining D."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "flash_wgmma"
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "flash_mma"
    return "flash_simple"


BWD_VARIANTS = ("bwd_simple", "bwd_mma", "bwd_wgmma")  # the backward launcher's variant codes 0, 1, 2


def bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels that a launch takes: ``bwd_wgmma`` (TMA,
    warp-specialised wgmma: Delta, dQ, dK/dV kernels) for bfloat16 with D in
    {64, 128} (128-row tiles) and {160, 256} (64-row tiles; D = 160 as three
    64-column panels); ``bwd_mma`` (mma.sync) for other bfloat16 with D % 16
    == 0 and D <= 128; ``bwd_simple`` (CUDA cores) for float32 and the rest."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "bwd_wgmma"
    return "bwd_mma" if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= 128 else "bwd_simple"


WIDE_HEAD_DIMS = (160, 256)  # bwd_wgmma's 64-row tiles, whose dK/dV CTAs may split a group's query heads


def bwd_splits(b: int, s: int, h: int, hkv: int, d: int, sms: int) -> int:
    """The CTAs over which bwd_wgmma at D 160 / 256 splits each KV group's
    query heads for dK/dV: the least divisor of H / Hkv that gives at least
    two CTAs per SM (one 64-key tile, batch row and KV head each; one CTA
    fits an SM), else H / Hkv.  1 elsewhere.  recurrentgemma_2b's MQA
    training shape (B = 2, S = 2048, 10 heads over 1) takes 5 (320 CTAs in
    place of 64); pixtral_12b's (32 over 8) already has 512 and takes 1."""
    rep = h // hkv
    if d not in WIDE_HEAD_DIMS:
        return 1
    ctas = -(-s // 64) * b * hkv
    return next((n for n in range(1, rep + 1) if rep % n == 0 and ctas * n >= 2 * sms), rep)


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
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
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
    if any(is_dtensor(a) for a in (q, k, v)):
        return _sharded(q, k, v, use_kernel, kind)
    if not use_kernel or (q.device.type == "cpu" and not is_fake(q)):
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


def _sharded(q, k, v, use_kernel, kind):
    """The wrapper on each rank's shard of DTensors q, k, v (see the module
    docstring); the output is a DTensor laid out as q."""
    return heads_local("flash attention", functools.partial(flash_attention_bshd, use_kernel=use_kernel, kind=kind),
                       q, k, v)


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
    if (dev.type != "cuda" and not is_fake(q)) or k.device != dev or v.device != dev:
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
    out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, kind or variant(q.dtype, q.shape[3]), with_lse)
    return out, lse if with_lse else None


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str, with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    dev = q.device
    b, s, h, d = q.shape
    if kind == "flash_wgmma" and any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("flash_wgmma reads q, k, v through TMA and needs them 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s) if with_lse else (0,), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().flash_attention_launch(
        _DTYPE_CODE[q.dtype], VARIANTS.index(kind), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, s, h, k.shape[2], d, 1.0 / d**0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel {kind} launch failed: cudaError {err} "
                           f"(B={b}, S={s}, H={h}, Hkv={k.shape[2]}, D={d})")
    count_launch("flash_attention", kind, (b, s, h, k.shape[2], d))
    return out, lse


@_fwd_op.register_fake
def _(q, k, v, kind, with_lse):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s) if with_lse else (0,), dtype=torch.float32)


def _launch_bwd(q, k, v, out, lse, dout, kind=None):
    """The backward kernel: (dq, dk, dv) in q's dtype from the forward's
    q, k, v, output and row log-sum-exp and the output's gradient.  ``kind``
    forces one of ``BWD_VARIANTS`` in place of ``bwd_variant(dtype, D)``'s
    choice (to time one variant against another); the launcher refuses a
    variant that cannot take the shape."""
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
    if kind is not None and kind not in BWD_VARIANTS:
        raise ValueError(f"kind must be one of {BWD_VARIANTS}, got {kind!r}")
    return torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, dout, kind or bwd_variant(q.dtype, d))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
            dout: torch.Tensor, kind: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    if kind != "bwd_simple" and any(a.data_ptr() % 16 for a in (q, k, v, out, dout, dq, dk, dv)):
        raise ValueError(f"flash_attention backward {kind} moves q, k, v, out, dout (through TMA in bwd_wgmma) and "
                         "dq, dk, dv in 16-byte pieces and needs them 16-byte aligned")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    splits = 1
    if kind == "bwd_wgmma":
        splits = bwd_splits(b, s, h, k.shape[2], d, torch.cuda.get_device_properties(q.device).multi_processor_count)
    # the splits' float32 partial dV and dK, summed in order by the launcher's last kernel
    part = torch.empty((2, splits, *k.shape), dtype=torch.float32, device=q.device) if splits > 1 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_library().flash_attention_bwd_launch(
        _DTYPE_CODE[q.dtype], BWD_VARIANTS.index(kind), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, s, h, k.shape[2], d, splits, 1.0 / d**0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel {kind} launch failed: cudaError {err} "
                           f"(B={b}, S={s}, H={h}, Hkv={k.shape[2]}, D={d}, splits={splits})")
    count_launch("flash_attention_bwd", kind, (b, s, h, k.shape[2], d))
    return dq, dk, dv


@_bwd_op.register_fake
def _(q, k, v, out, lse, dout, kind):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def fwd_flops(b: int, s: int, h: int, d: int) -> float:
    """Causal attention's products over the causal half: 2 * 2 B H S^2 D / 2."""
    return 2.0 * b * h * s * s * d


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, *args, **kwargs) -> float:
    b, s, h, d = q_shape
    return fwd_flops(b, s, h, d)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, *args, **kwargs) -> float:
    b, s, h, d = q_shape
    return 2.5 * fwd_flops(b, s, h, d)
