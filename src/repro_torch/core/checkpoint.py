"""Sweep checkpoint/resume: crash-durable DMRG state.

A ground-state run is hours of sweeping; a crash at sweep 40 of 50 should
cost one site update, not the run.  This module serializes everything a
mid-sweep resume needs to continue with the uninterrupted run's energies
(bit-identical in practice):

- the MPS tensors;
- BOTH environment lists, exactly as they stood: mid left-to-right sweep
  the right environments are partly stale leftovers of the previous
  half-sweep, a state a fresh right-to-left rebuild cannot reproduce;
- the schedule position (bond index, sweep index) and the in-sweep resume
  dict (phase, next site, partial accumulators) that ``DMRGEngine.sweep``
  hands its ``on_site`` callback;
- the finished sweeps' stats and the Davidson seed.

Determinism does the rest: Davidson starts from the MPS, its restarts are
seeded per site (``seed + j``), and truncation replays from the same
singular values.  The CUDA graph cache is not saved: a resumed run captures
its structures again.

Format: stdlib pickle of a dict whose leaves are numpy arrays and plain
Python structure (``Index`` is a frozen dataclass of int tuples); no torch
tensor is pickled, so a checkpoint written on the card resumes on the CPU
and back.  Writes are atomic (temporary file, fsync, ``os.replace``) and
pruned to the newest ``keep`` files, so a crash mid-write cannot corrupt
the newest good checkpoint.  Unpickling runs code: load only checkpoints
this program wrote.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import re
import tempfile
import time
from typing import Dict, List, Optional

import torch

from ..tensor.blocksparse import BlockSparseTensor

CHECKPOINT_VERSION = 1
_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.pkl$")


# ---------------------------------------------------------- tensor (de)hydrate
def tensor_state(t: Optional[BlockSparseTensor]):
    """Picklable form of a block-sparse tensor (None passes through).

    Blocks are copied to host numpy with ``.cpu().numpy()``, an exact bit
    copy, which is what the resume-equality guarantee rests on.
    """
    if t is None:
        return None
    return t.indices, t.charge, {k: b.detach().cpu().numpy() for k, b in t.blocks.items()}


def tensor_restore(state, device) -> Optional[BlockSparseTensor]:
    """Inverse of ``tensor_state``: the blocks on ``device``, bit for bit."""
    if state is None:
        return None
    indices, charge, blocks = state
    return BlockSparseTensor(indices, {k: torch.from_numpy(v).to(device) for k, v in blocks.items()}, charge)


class CheckpointManager:
    """Atomic, pruned pickle checkpoints in one directory.

    ``directory``: where ``ckpt_<step>.pkl`` files live (created if
    missing).  ``every``: the save cadence in site updates (``maybe_save``
    writes when the state's step is a multiple of it; the driver also saves
    at every sweep boundary).  ``keep``: the newest checkpoints kept after
    each save (>= 1); two keep the previous good file even if the host dies
    the instant after ``os.replace``.  ``saves`` and ``save_seconds`` count
    the writes and their host time.
    """

    def __init__(self, directory: str, every: int = 1, keep: int = 2):
        if every < 1 or keep < 1:
            raise ValueError(f"every={every} and keep={keep} must be >= 1")
        self.directory = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self.saves = 0
        self.save_seconds = 0.0

    # ------------------------------------------------------------------ save
    def save(self, state: Dict) -> str:
        """Atomically write ``state`` (named by ``state["step"]``)."""
        t0 = time.perf_counter()
        state = dict(state, version=CHECKPOINT_VERSION)
        path = os.path.join(self.directory, f"ckpt_{int(state['step']):08d}.pkl")
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=".ckpt_tmp_", suffix=".pkl")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic: readers see the old file or the new, never a torn one
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.saves += 1
        self._prune()
        self.save_seconds += time.perf_counter() - t0
        return path

    def maybe_save(self, state: Dict) -> Optional[str]:
        """Save iff the step counter hits the cadence; returns the path."""
        if int(state["step"]) % self.every == 0:
            return self.save(state)
        return None

    # ------------------------------------------------------------------ load
    def _list(self) -> List[str]:
        names = sorted(n for n in os.listdir(self.directory) if _CKPT_RE.match(n))
        return [os.path.join(self.directory, n) for n in names]

    def load_latest(self) -> Optional[Dict]:
        """The newest readable checkpoint of this version, or None (a fresh
        start).  Walks newest to oldest, so a truncated newest file (a crash
        mid-write on a filesystem without atomic rename) falls back to the
        previous good one."""
        for path in reversed(self._list()):
            try:
                with open(path, "rb") as f:
                    state = pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError):
                continue
            if isinstance(state, dict) and state.get("version") == CHECKPOINT_VERSION:
                return state
        return None

    def _prune(self) -> None:
        for path in self._list()[: -self.keep]:
            try:
                os.unlink(path)
            except OSError:
                pass


# ------------------------------------------------------- driver state helpers
def pack_run_state(*, step: int, bond_idx: int, sweep_idx: int, sweep_resume: Optional[Dict], mps_tensors,
                   left_envs, right_envs, stats, seed: int) -> Dict:
    """The whole ``run_dmrg`` state as one picklable dict (see the module
    docstring)."""
    return {
        "step": step,
        "bond_idx": bond_idx,
        "sweep_idx": sweep_idx,
        "sweep_resume": sweep_resume,
        "mps": [tensor_state(t) for t in mps_tensors],
        "left_envs": [tensor_state(t) for t in left_envs],
        "right_envs": [tensor_state(t) for t in right_envs],
        "stats": [dataclasses.asdict(s) for s in stats],
        "seed": seed,
    }


def unpack_envs(state: Dict, device):
    """The restored ``(left_envs, right_envs)`` lists for ``DMRGEngine``,
    on ``device``."""
    return (
        [tensor_restore(s, device) for s in state["left_envs"]],
        [tensor_restore(s, device) for s in state["right_envs"]],
    )
