"""Model API of the port's LM scaffold: ``init / forward / init_cache /
decode_step`` over every architecture, dispatching on ``cfg.family``
(``"audio"`` is Whisper's encoder-decoder, the rest the decoder-only LM).
``init`` and ``init_cache`` take ``device=None``, which means the CUDA
card; ``forward`` and ``decode_step`` run where the parameters lie.  A
Whisper cache is primed with ``whisper.whisper_prime_cache`` before its
first decode step."""
from __future__ import annotations

from typing import Dict

import torch

from ..device import resolve_device
from . import lm as _lm
from . import whisper as _wh


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    if cfg.family == "audio":
        return _wh.init_whisper(cfg, generator, resolve_device(device))
    return _lm.init_lm(cfg, generator, resolve_device(device))


def forward(cfg, params: Dict, batch: Dict, *, use_kernel: bool = True):
    """batch: ``tokens`` [B,S], with ``patch_embeds`` [B,P,D] for a VLM and
    ``enc_embeds`` [B,F,D] for Whisper."""
    if cfg.family == "audio":
        return _wh.whisper_forward(cfg, params, batch["enc_embeds"], batch["tokens"], use_kernel=use_kernel)
    return _lm.lm_forward(cfg, params, batch["tokens"], batch.get("patch_embeds"), use_kernel=use_kernel)


def init_cache(cfg, batch: int, cache_len: int, device=None) -> Dict[str, torch.Tensor]:
    if cfg.family == "audio":
        return _wh.init_whisper_cache(cfg, batch, cache_len, resolve_device(device))
    return _lm.init_decode_cache(cfg, batch, cache_len, resolve_device(device))


def decode_step(cfg, params: Dict, cache: Dict, token, pos):
    if cfg.family == "audio":
        return _wh.whisper_decode_step(cfg, params, cache, token, pos)
    return _lm.lm_decode_step(cfg, params, cache, token, pos)
