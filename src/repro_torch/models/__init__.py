"""Model API of the port's LM slice: ``init / forward / init_cache /
decode_step`` for the dense and ssm families (the audio family, Whisper, is
ROADMAP Queue 1 #13).  ``init`` and ``init_cache`` take ``device=None``,
which means the CUDA card; ``forward`` and ``decode_step`` run where the
parameters lie."""
from __future__ import annotations

from typing import Dict

import torch

from ..device import resolve_device
from . import lm as _lm


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    return _lm.init_lm(cfg, generator, resolve_device(device))


def forward(cfg, params: Dict, batch: Dict, *, use_kernel: bool = True):
    if batch.get("patch_embeds") is not None:
        raise NotImplementedError("VLM patch inputs are not ported yet (ROADMAP Queue 1 #13)")
    return _lm.lm_forward(cfg, params, batch["tokens"], use_kernel=use_kernel)


def init_cache(cfg, batch: int, cache_len: int, device=None) -> Dict[str, torch.Tensor]:
    return _lm.init_decode_cache(cfg, batch, cache_len, resolve_device(device))


def decode_step(cfg, params: Dict, cache: Dict, token, pos):
    return _lm.lm_decode_step(cfg, params, cache, token, pos)
