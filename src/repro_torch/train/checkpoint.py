"""Fault-tolerant, asynchronous checkpointing of flat dicts of tensors.

The reference's layout and protocol (``repro.train.checkpoint``):
  * crash consistency -- arrays + manifest are written to a temp dir,
    fsynced, then atomically renamed to ``step_%010d``; a partial write can
    never be mistaken for a checkpoint, so restart always finds the last
    COMPLETE step;
  * async -- ``save_async`` snapshots the tensors to host memory, then
    writes in a background thread, one write in flight at a time; a failed
    write surfaces on the next ``wait()``;
  * bounded retention -- keep the newest ``keep`` checkpoints.

``arrays.npz`` holds each tensor as numpy; numpy has no bfloat16, so a bf16
tensor is stored as its uint16 bits and its manifest entry says
``"bfloat16"``.  A DTensor is saved whole (``full_tensor()``, a collective
that every rank of its mesh joins), so a checkpoint is free of any mesh;
under a mesh only the manager built with ``writer=True`` (rank 0) writes.
``restore(device=)`` puts the arrays on one device; with ``mesh`` and
``shardings`` (path -> placements) each rank reads the whole file and
keeps its own shard of every listed array (``distribute_tensor`` without
communication): the reference's elastic restore onto a mesh that need not
be the one that saved.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device


def _to_host(t: torch.Tensor):
    """(numpy array, manifest dtype name) of a tensor, of a DTensor whole."""
    from ..models.common import is_dtensor

    t = t.detach()
    t = (t.full_tensor() if is_dtensor(t) else t).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.writer = writer  # under a mesh: the one rank that writes
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, arrays: Dict[str, torch.Tensor], meta: Optional[Dict] = None):
        """Blocking save of a flat dict of tensors + JSON-able metadata."""
        host = {k: _to_host(v) for k, v in arrays.items()}
        if self.writer:
            self._write(step, host, meta or {})

    def save_async(self, step: int, arrays: Dict[str, torch.Tensor], meta: Optional[Dict] = None):
        """Snapshot to host now, write in the background."""
        self.wait()  # one in-flight checkpoint at a time
        host = {k: _to_host(v) for k, v in arrays.items()}
        if not self.writer:
            return
        meta = dict(meta or {})

        def work():
            try:
                self._write(step, host, meta)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: Dict[str, tuple], meta: Dict):
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=self.dir))
        try:
            np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in host.items()})
            manifest = dict(
                step=step,
                time=time.time(),
                arrays={k: dict(shape=list(a.shape), dtype=dt) for k, (a, dt) in host.items()},
                meta=meta,
            )
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = self.dir / f"step_{step:010d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic completion marker
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None, *, mesh=None, shardings: Optional[Dict] = None):
        """Returns (step, arrays, meta), the arrays as tensors on ``device``
        (``None`` means the CUDA card) in their saved dtypes; each array that
        ``shardings`` lists as a DTensor on ``mesh`` with those placements."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        dev = resolve_device(device)
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as data:
            arrays = {k: _from_host(data[k], info["dtype"]).to(dev) for k, info in manifest["arrays"].items()}
        if shardings:
            from torch.distributed.tensor import distribute_tensor

            arrays = {k: distribute_tensor(v, mesh, shardings[k], src_data_rank=None) if k in shardings else v
                      for k, v in arrays.items()}
        return step, arrays, manifest["meta"]
