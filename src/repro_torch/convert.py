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


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 included, which numpy knows only through
    ``ml_dtypes``) as a tensor of the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _lm_arrays(arrays: Dict[str, np.ndarray], cfg, want: Dict[str, Tuple[int, ...]], what: str, device):
    """Checks ``arrays`` against the port's keys and shapes ``want`` and
    carries them across."""
    device = resolve_device(device)
    if set(arrays) != set(want):
        raise ValueError(f"{cfg.name} {what}: keys differ from the port's: "
                         f"missing {sorted(set(want) - set(arrays))}, extra {sorted(set(arrays) - set(want))}")
    out = {}
    for k, shape in want.items():
        if tuple(np.shape(arrays[k])) != shape:
            raise ValueError(f"{cfg.name} {what} {k}: shape {np.shape(arrays[k])}, the port's is {shape}")
        out[k] = _tensor(arrays[k], device)
    return out


def lm_params_from_numpy(params: Dict[str, np.ndarray], cfg, device=None) -> Dict[str, torch.Tensor]:
    """LM parameters from the reference's flat dict of arrays (``np.asarray``
    of each leaf), on ``device`` (``None`` means the CUDA card), for every
    architecture: the pattern positions stacked under ``blocks/L{i}/``,
    the remainder layers under ``rem{j}/``, Whisper's stacks under
    ``enc/`` and ``dec/``.  The port keeps the same keys, shapes and
    dtypes."""
    from . import models

    shapes = {k: tuple(v.shape) for k, v in models.init(cfg, None, "meta").items()}
    return _lm_arrays(params, cfg, shapes, "params", device)


def convert_cache(cache: Dict[str, np.ndarray], cfg, device=None) -> Dict[str, torch.Tensor]:
    """A decode cache from the reference's flat dict of arrays, so that a
    decode can resume from the reference's state: KV caches (a ring of
    ``local_window`` slots for a windowed layer, int8 values with their
    float32 scales), RG-LRU ``h``/``conv`` and RWKV6 states, stacked
    (``blocks/L{i}/``) or not (``rem{j}/``), and Whisper's self and cross
    caches."""
    from . import models

    def lead(key):  # stacked entries carry a leading layer axis before the batch
        return 1 if key.startswith("blocks/") or cfg.family == "audio" else 0

    key = next(iter(cache))
    batch = np.shape(cache[key])[lead(key)]
    # a KV entry's slots (any cache_len at or past a ring's window gives the
    # same ring); a cache of recurrent state alone has none
    kv = [k for k in cache if k == "self_k" or k.endswith("/k")]
    cache_len = np.shape(cache[kv[0]])[lead(kv[0]) + 1] if kv else 0
    meta = models.init_cache(cfg, batch, cache_len, "meta")
    return _lm_arrays(cache, cfg, {k: tuple(v.shape) for k, v in meta.items()}, "cache", device)
