"""Carry state into the port from plain data.

A tensor travels as ``(index_specs, charge, blocks)``: ``index_specs`` a
list of ``(sectors, flow, name)`` per mode, ``charge`` a tuple of ints and
``blocks`` a dict from block key to ``np.ndarray``.  Any producer of that
form (for instance the reference package, with ``np.asarray`` on each block)
can hand an MPS or MPO to the port unchanged, so both optimize the *same*
operator.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .core.mps import MPS
from .device import resolve_device
from .tensor.blocksparse import BlockSparseTensor
from .tensor.qn import Index

TensorArrays = Tuple[Sequence[Tuple], Tuple[int, ...], Dict[Tuple[int, ...], np.ndarray]]


def bst_from_arrays(index_specs, charge, blocks, *, device=None, dtype=torch.float64) -> BlockSparseTensor:
    """One port tensor from plain data, on ``device`` (``None`` means the
    CUDA card, raising when there is none)."""
    device = resolve_device(device)
    indices = [
        Index(tuple((tuple(q), int(d)) for q, d in sectors), int(flow), name)
        for sectors, flow, name in index_specs
    ]
    t = BlockSparseTensor(
        indices,
        {tuple(k): torch.tensor(np.asarray(b), dtype=dtype, device=device) for k, b in blocks.items()},
        tuple(charge),
    )
    t.check()
    return t


def mpo_from_arrays(tensors: Sequence[TensorArrays], *, device=None, dtype=torch.float64) -> List[BlockSparseTensor]:
    """An MPO (list of site tensors) from plain data, one triple per site."""
    return [bst_from_arrays(*t, device=device, dtype=dtype) for t in tensors]


def mps_from_arrays(tensors: Sequence[TensorArrays], *, device=None, dtype=torch.float64) -> MPS:
    """An MPS from plain data, one triple per site."""
    return MPS(mpo_from_arrays(tensors, device=device, dtype=dtype))
