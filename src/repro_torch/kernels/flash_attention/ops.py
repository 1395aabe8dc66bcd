"""Wrapper of causal flash attention (``flash_attention.cu``) in the
models' [B, S, H, D] layout with grouped KV heads.

On a CUDA tensor it launches the hand-written kernel, or raises: it never
falls back to the plain version.  The plain version (``ref.py``) runs only
for tensors that lie on the CPU, or when the caller asks for it with
``use_kernel=False``.
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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
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
    return _launch(q, k, v, kind)


def _plain(q, k, v):
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    to_bh = lambda a: a.transpose(1, 2).reshape(b * h, s, d)
    o = flash_attention_ref(to_bh(q), to_bh(k), to_bh(v))
    return o.reshape(b, h, s, d).transpose(1, 2)


def _launch(q, k, v, kind=None) -> torch.Tensor:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, got {dev}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    b, s, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    kind = kind or variant(q.dtype, d)
    if kind == "flash_wgmma" and any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("flash_wgmma reads q, k, v through TMA and needs them 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().flash_attention_launch(
        _DTYPE_CODE[q.dtype], VARIANTS.index(kind), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], d, 1.0 / d**0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel {kind} launch failed: cudaError {err} "
                           f"(B={b}, S={s}, H={h}, Hkv={k.shape[2]}, D={d})")
    count_launch("flash_attention", kind)
    return out
