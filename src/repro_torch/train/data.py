"""Deterministic, restorable synthetic token pipeline.

The reference's generator, unchanged: structured synthetic sequences (a
mixture of Zipfian unigrams and copy/induction motifs, so models actually
reduce loss on it) from numpy's counter-seeded generator
``np.random.default_rng((seed, step))``, so state == (seed, step) and
restore-after-restart is exact and O(1).  The port draws the reference's
batches bit for bit and hands them over as int64 tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d: Dict) -> "DataState":
        return DataState(int(d["seed"]), int(d["step"]))


class SyntheticLM:
    """Batch generator: tokens [B, S+1] -> (inputs, labels) pairs on
    ``device`` (``None`` means the CUDA card)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2, motif_frac: float = 0.3, device=None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.device = resolve_device(device)
        self.state = DataState(seed, 0)
        # Zipfian unigram table (stable across restarts)
        ranks = np.arange(1, vocab_size + 1)
        p = 1.0 / ranks**zipf_a
        self.probs = p / p.sum()
        self.motif_frac = motif_frac

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.state.seed, self.state.step))
        self.state.step += 1
        toks = rng.choice(self.vocab, size=(self.batch, self.seq + 1),
                          p=self.probs).astype(np.int32)
        # induction motifs: copy a random span forward (gives the model
        # something learnable beyond unigram statistics)
        n_motif = int(self.batch * self.motif_frac)
        if n_motif and self.seq >= 16:
            span = min(8, self.seq // 4)
            src = rng.integers(0, self.seq // 2 - span, size=n_motif)
            dst = rng.integers(self.seq // 2, self.seq + 1 - span, size=n_motif)
            rows = rng.choice(self.batch, size=n_motif, replace=False)
            for r, s_, d_ in zip(rows, src, dst):
                toks[r, d_ : d_ + span] = toks[r, s_ : s_ + span]
        toks = torch.from_numpy(toks.astype(np.int64))
        return {
            "tokens": toks[:, :-1].to(self.device),
            "labels": toks[:, 1:].to(self.device),
        }

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def load_state_dict(self, d: Dict):
        self.state = DataState.from_dict(d)
