"""Step functions of the LM serving path (the reference's
``make_prefill_step`` / ``make_decode_step``).  The dry-run cells, meshes
and HLO costing of the reference's ``specs.py`` are ROADMAP Queue 1 #13."""
from __future__ import annotations

from .. import models


def make_prefill_step(cfg):
    def prefill(params, batch):
        logits = models.forward(cfg, params, batch)
        return logits[:, -1, : cfg.vocab_size]  # next-token logits

    return prefill


def make_decode_step(cfg):
    def decode(params, cache, token, pos):
        return models.decode_step(cfg, params, cache, token, pos)

    return decode
