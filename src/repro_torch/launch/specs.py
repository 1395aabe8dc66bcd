"""Step functions and inputs of the LM serving path (the reference's
``batch_specs`` / ``make_prefill_step`` / ``make_decode_step``).  The
training step, the dry-run cells, meshes and HLO costing of the
reference's ``specs.py`` are ROADMAP Queue 1 #13 items 4 and 5."""
from __future__ import annotations

from typing import Dict

import torch

from .. import models
from ..device import resolve_device
from ..models.common import dtype_of


def make_batch(cfg, batch: int, seq_len: int, generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """A prefill batch of real tensors drawn from ``generator``, shaped as
    the reference's ``batch_specs``: ``seq_len`` positions in all, of which
    a VLM's first ``n_patches`` are patch embeddings (so its ``tokens`` are
    ``seq_len - n_patches`` long); Whisper's ``enc_embeds`` are
    ``[batch, enc_seq_len, d_model]`` beside ``seq_len`` tokens."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    out = {}
    s_text = seq_len
    if cfg.family == "vlm":
        s_text = seq_len - cfg.n_patches
        out["patch_embeds"] = torch.randn(batch, cfg.n_patches, cfg.d_model, generator=generator, device=dev).to(dt)
    if cfg.family == "audio":
        out["enc_embeds"] = torch.randn(batch, cfg.enc_seq_len, cfg.d_model, generator=generator, device=dev).to(dt)
    out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, s_text), generator=generator, device=dev)
    return out


def make_prefill_step(cfg):
    def prefill(params, batch):
        logits = models.forward(cfg, params, batch)
        return logits[:, -1, : cfg.vocab_size]  # next-token logits

    return prefill


def make_decode_step(cfg):
    def decode(params, cache, token, pos):
        return models.decode_step(cfg, params, cache, token, pos)

    return decode
