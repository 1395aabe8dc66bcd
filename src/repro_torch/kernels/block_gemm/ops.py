"""Wrapper of the segmented batched block GEMM (``block_gemm.cu``).

On a CUDA tensor it launches the hand-written kernel, or raises: it never
falls back to the plain version.  The plain version (``ref.py``) runs only
for tensors that lie on the CPU, or when the caller asks for it with
``use_kernel=False``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from .. import LAUNCHES
from ..build import load_library
from .ref import block_sparse_matmul_ref

SOURCE = Path(__file__).with_name("block_gemm.cu")
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.block_gemm_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def segments(out_idx, num_out: int) -> np.ndarray:
    """Host ``seg`` [O+1] of a sorted host ``out_idx``: pairs of output block
    o are ``seg[o]:seg[o+1]`` (empty for an output block with no pair)."""
    oi = np.asarray(out_idx, dtype=np.int64)
    if oi.ndim != 1:
        raise ValueError(f"out_idx must be 1-D, got shape {oi.shape}")
    if oi.size and (np.any(np.diff(oi) < 0) or oi[0] < 0 or oi[-1] >= num_out):
        raise ValueError(f"out_idx must be sorted and lie in [0, {num_out})")
    return np.searchsorted(oi, np.arange(num_out + 1), side="left").astype(np.int32)


def block_sparse_matmul(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    out_idx,
    num_out: int,
    *,
    seg: torch.Tensor | None = None,
    extents: torch.Tensor | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Batched block-sparse GEMM: out[o] = sum_{p:out_idx[p]=o} lhs[p]@rhs[p].

    ``lhs`` [P, BM, BK], ``rhs`` [P, BK, BN], ``out_idx`` [P] sorted
    ascending (a numpy array or a tensor), ``out`` [num_out, BM, BN].  Output
    blocks with no pair come back as zeros on every path.

    Kernel-only extras, both built once per plan by the csr layout:
    ``seg`` is the int32 [num_out+1] segment table on the card (built here
    from ``out_idx`` when absent), and ``extents`` an int32 [P, 3] table of
    each pair's true (rows, depth, cols), beyond which the packed operands
    are zero and the kernel skips them.
    """
    if lhs.dim() != 3 or rhs.dim() != 3 or lhs.shape[0] != rhs.shape[0] or lhs.shape[2] != rhs.shape[1]:
        raise ValueError(f"shapes do not chain: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}")
    if not use_kernel or lhs.device.type == "cpu":
        return block_sparse_matmul_ref(lhs, rhs, out_idx, num_out)
    return _launch(lhs, rhs, out_idx, num_out, seg, extents)


def _launch(lhs, rhs, out_idx, num_out, seg, extents) -> torch.Tensor:
    dev = lhs.device
    if dev.type != "cuda" or rhs.device != dev:
        raise ValueError(f"block_gemm kernel needs both operands on one CUDA device, got {dev} and {rhs.device}")
    if lhs.dtype not in _DTYPE_CODE or rhs.dtype != lhs.dtype:
        raise TypeError(f"block_gemm kernel takes float64, float32 or bfloat16, got {lhs.dtype} and {rhs.dtype}")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("block_gemm kernel needs contiguous operands")
    P, BM, BK = lhs.shape
    BN = rhs.shape[2]
    if seg is None:
        if torch.is_tensor(out_idx):
            out_idx = out_idx.cpu().numpy()
        if len(out_idx) != P:
            raise ValueError(f"out_idx has {len(out_idx)} entries for {P} pairs")
        seg = torch.from_numpy(segments(out_idx, num_out)).to(dev)
    if seg.dtype != torch.int32 or seg.device != dev or tuple(seg.shape) != (num_out + 1,):
        raise ValueError("seg must be an int32 [num_out+1] tensor on the operands' device")
    if extents is not None and (
        extents.dtype != torch.int32 or extents.device != dev
        or tuple(extents.shape) != (P, 3) or not extents.is_contiguous()
    ):
        raise ValueError("extents must be a contiguous int32 [P, 3] tensor on the operands' device")
    out = torch.empty((num_out, BM, BN), dtype=lhs.dtype, device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().block_gemm_launch(
        _DTYPE_CODE[lhs.dtype], lhs.data_ptr(), rhs.data_ptr(), seg.data_ptr(),
        None if extents is None else extents.data_ptr(), out.data_ptr(),
        num_out, BM, BK, BN, stream,
    )
    if err != 0:
        raise RuntimeError(f"block_gemm kernel launch failed: cudaError {err} (P={P}, BM={BM}, BK={BK}, BN={BN}, O={num_out})")
    LAUNCHES["block_gemm"] += 1
    return out
