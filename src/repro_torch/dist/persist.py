"""Persistent plan store: a fresh process starts at warm-cache speed.

A fresh worker pays the whole planning pipeline on its first sweep, though
every artifact it builds is a pure function of block *structure* that an
earlier worker already derived.  This module keeps two tiers of that work
across processes (the reference's ``src/repro/dist/persist.py``):

1. **Plan tables** (``ContractionPlan`` / ``DecompositionPlan`` /
   ``EnvironmentPlan``), ported as they are: host data keyed by structural
   signature in the ``_SignatureLRU`` caches (``dist/plan.py``).
   ``PlanStore`` maps a canonical signature digest to a pickled,
   version-gated entry on disk; the caches consult it on a miss and write
   back after a build, so a primed store means zero plan builds.  A plan is
   stored as host data only: the device tables it memoizes (index tables,
   work-list tables) are stripped when it is pickled (the layouts'
   ``__getstate__``) and uploaded again at first use in the loading
   process, as the reference strips its device arrays.
2. **Structure records**, in place of the reference's executable tier.  A
   CUDA graph does not outlive its process, so there is nothing compiled to
   store.  Instead the store records the padded structures each
   ``GraphCache`` captured (matvec and environment graphs, with their dtype
   and problem axis) and the SVD stack shapes the decomposition ran, under
   a port fingerprint (torch version, CUDA version, device capability and a
   hash of the kernel sources).  ``warmup(engine, store, device)`` captures
   those structures before the first sweep, so the sweep itself captures
   nothing.  The reference's other two layers have no torch counterpart
   and are not imitated: ``jax.export`` (a serialized StableHLO program)
   and the XLA persistent compilation cache.  The kernels are built once
   per source hash by ``kernels/build.py`` already.

Store layout (``PlanStore(root)``)::

    root/
      contraction/<digest>.pkl   one entry per canonical plan signature
      decomp/<digest>.pkl
      env/<digest>.pkl
      structures/<digest>.pkl    the structure records of one fingerprint

Every entry is written atomically (a temporary file in the target
directory, fsync, ``os.replace``), so concurrent writers race to a complete
file and readers never see a torn one.  Two processes that flush structure
records at once may lose one's additions (the last writer wins); a lost
record costs one capture, never a wrong result.

Version and signature gating: a plan entry records ``PERSIST_VERSION``, its
kind and its canonical signature; a load checks all three and treats any
mismatch, or a pickle that does not load, as a counted miss, never a crash.
The store trusts its own directory (entries are pickles): point it only at
paths you would trust a checkpoint from.

``canonical_signature`` rewrites every ``Index`` to its ``(sectors, flow)``
pair before hashing, since ``Index`` equality ignores the ``name``: names
can neither fragment nor alias the store.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import os
import pickle
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..tensor.blocksparse import BlockSparseTensor
from ..tensor.qn import Index
from . import plan as _plan_mod

# Bump on ANY change to plan dataclass layout, signature canonicalization or
# entry schema: old stores are then rejected wholesale (counted as ``stale``)
# and rebuilt, never misread.
PERSIST_VERSION = 1

# subdirectory per plan kind; the kind string is also stored in each entry
# and checked on load, so a digest collision across kinds cannot alias
PLAN_KINDS = ("contraction", "decomp", "env")

_KERNEL_SOURCES = ("block_gemm/block_gemm.cu", "flash_attention/flash_attention.cu", "rwkv6_scan/rwkv6_scan.cu")


def canonical_signature(sig: Any) -> Any:
    """A structural signature in its name-free canonical form: every
    ``Index`` becomes ``("Ix", sectors, flow)``, tuples are mapped through,
    everything else passes as it is."""
    if isinstance(sig, Index):
        return ("Ix", sig.sectors, sig.flow)
    if isinstance(sig, tuple):
        return tuple(canonical_signature(x) for x in sig)
    return sig


def signature_digest(sig: Any) -> str:
    """Stable hex digest of a signature's canonical form (store filename)."""
    return hashlib.sha256(repr(canonical_signature(sig)).encode()).hexdigest()


def _atomic_write_bytes(path: str, payload: bytes) -> None:
    """A temporary file in the target directory, fsync, rename."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


@functools.cache
def _sources_hash() -> str:
    root = Path(__file__).resolve().parent.parent / "kernels"
    h = hashlib.sha256()
    for rel in _KERNEL_SOURCES:
        h.update((root / rel).read_bytes())
    return h.hexdigest()


def port_fingerprint(device) -> Tuple:
    """What a structure record is valid for: the persist version, torch and
    CUDA versions, the device's capability ("cpu" on the CPU) and a hash of
    the kernel sources.  Plans need none (they are host data)."""
    device = torch.device(device)
    cap = torch.cuda.get_device_capability(device) if device.type == "cuda" else "cpu"
    return (PERSIST_VERSION, torch.__version__, torch.version.cuda, cap, _sources_hash())


def structure_of(t: BlockSparseTensor) -> Tuple:
    """A tensor's structure as a record holds it: indices, charge, sorted
    block keys and the leading problem axes of its blocks."""
    keys = tuple(sorted(t.blocks))
    lead: Tuple[int, ...] = ()
    if keys:
        blk = t.blocks[keys[0]]
        lead = tuple(blk.shape[: blk.dim() - len(t.indices)])
    return (tuple(t.indices), t.charge, keys, lead)


def zeros_of(struct: Tuple, dtype: torch.dtype, device) -> BlockSparseTensor:
    """A tensor of zeros with a recorded structure."""
    indices, charge, keys, lead = struct
    probe = BlockSparseTensor(indices, {}, charge)
    return BlockSparseTensor(indices, {k: torch.zeros(lead + probe.block_shape(k), dtype=dtype, device=device)
                                       for k in keys}, charge)


class PlanStore:
    """Versioned on-disk store of plan tables and structure records.

    Thread-safe (one lock guards the counters and the pending records; file
    operations are atomic on their own) and multi-process-safe (atomic
    writes, tolerant reads).  Counters are cumulative per instance; see
    ``stats()``.
    """

    def __init__(self, root):
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = self.misses = self.saves = self.corrupt = self.stale = 0
        self.structure_loads = self.structure_saves = self.structure_corrupt = 0
        # fingerprint -> records noted in this process and not yet flushed
        self._pending: Dict[Tuple, List] = {}
        self._seen: Dict[Tuple, set] = {}

    # ---------------------------------------------------------------- layout
    def _plan_path(self, kind: str, sig: Any) -> str:
        if kind not in PLAN_KINDS:
            raise ValueError(f"unknown plan kind {kind!r}; one of {PLAN_KINDS}")
        return os.path.join(self.root, kind, signature_digest(sig) + ".pkl")

    def _structure_path(self, fingerprint: Tuple) -> str:
        return os.path.join(self.root, "structures", signature_digest(fingerprint) + ".pkl")

    # ----------------------------------------------------------- plan entries
    def load_plan(self, kind: str, sig: Any):
        """The plan stored for ``sig``, or None (missing, corrupt, stale).

        Never raises on a bad entry: truncated pickles, foreign payloads,
        version or signature mismatches are counted and return None; the
        caller rebuilds and its save repairs the entry.
        """
        path = self._plan_path(kind, sig)
        try:
            with open(path, "rb") as f:
                entry = pickle.load(f)
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            return None
        except Exception:
            with self._lock:
                self.corrupt += 1
            return None
        if not isinstance(entry, dict) or entry.get("version") != PERSIST_VERSION:
            with self._lock:
                self.stale += 1
            return None
        if entry.get("kind") != kind or entry.get("signature") != canonical_signature(sig) or "plan" not in entry:
            with self._lock:
                self.corrupt += 1
            return None
        with self._lock:
            self.hits += 1
        return entry["plan"]

    def save_plan(self, kind: str, sig: Any, plan: Any) -> bool:
        """Atomically persist ``plan`` under ``sig``; False on an IO error.

        A contraction plan's layouts are derived first (``materialize``), so
        the priming process derives them once and loaders never do.
        """
        if hasattr(plan, "materialize"):
            plan.materialize()
        entry = {"version": PERSIST_VERSION, "kind": kind, "signature": canonical_signature(sig), "plan": plan}
        try:
            _atomic_write_bytes(self._plan_path(kind, sig), pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL))
        except OSError:
            return False
        with self._lock:
            self.saves += 1
        return True

    # ------------------------------------------------------ structure records
    def note_structure(self, record: Tuple, device) -> None:
        """Remember one captured structure (or SVD stack) of this process,
        under the fingerprint of ``device``; written by ``flush``."""
        fp = port_fingerprint(device)
        with self._lock:
            seen = self._seen.setdefault(fp, set())
            if record not in seen:
                seen.add(record)
                self._pending.setdefault(fp, []).append(record)

    def _read_structures(self, fp: Tuple) -> List:
        try:
            with open(self._structure_path(fp), "rb") as f:
                entry = pickle.load(f)
        except FileNotFoundError:
            return []
        except Exception:
            with self._lock:
                self.structure_corrupt += 1
            return []
        if not isinstance(entry, dict) or entry.get("fingerprint") != fp or not isinstance(entry.get("records"), list):
            with self._lock:
                self.structure_corrupt += 1
            return []
        return entry["records"]

    def structures(self, device) -> List[Tuple]:
        """The records stored for ``device``'s fingerprint, in the order
        they were first captured (another fingerprint's are never read)."""
        records = self._read_structures(port_fingerprint(device))
        with self._lock:
            self.structure_loads += len(records)
        return records

    def flush(self) -> int:
        """Merge this process's new records into the store; returns how
        many it added."""
        with self._lock:
            pending, self._pending = self._pending, {}
        added = 0
        for fp, records in pending.items():
            have = self._read_structures(fp)
            known = set(have)
            new = [r for r in records if r not in known]
            if not new:
                continue
            entry = {"version": PERSIST_VERSION, "fingerprint": fp, "records": have + new}
            _atomic_write_bytes(self._structure_path(fp), pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL))
            added += len(new)
        with self._lock:
            self.structure_saves += added
        return added

    # ------------------------------------------------------------- reporting
    def stats(self) -> Dict[str, Any]:
        """Cumulative store counters.

        The reference's plan-tier keys, same meaning: ``hits`` / ``misses``
        / ``saves`` are plan loads that verified / found nothing / writes;
        ``corrupt`` counts unreadable or mismatched entries and ``stale``
        version rejections (both behave as misses).  The structure tier
        replaces the reference's ``export_*`` keys (there is no export):
        ``structure_loads`` records read for warmups, ``structure_saves``
        records added by flushes, ``structure_corrupt`` record files that
        did not load, ``structure_pending`` records noted and not flushed.
        """
        with self._lock:
            return {
                "root": self.root,
                "hits": self.hits,
                "misses": self.misses,
                "saves": self.saves,
                "corrupt": self.corrupt,
                "stale": self.stale,
                "structure_loads": self.structure_loads,
                "structure_saves": self.structure_saves,
                "structure_corrupt": self.structure_corrupt,
                "structure_pending": sum(len(v) for v in self._pending.values()),
            }


# ------------------------------------------------------------- activation
_active_store: Optional[PlanStore] = None


def activate_store(store) -> PlanStore:
    """Attach ``store`` (a PlanStore or a path) as the process-wide store:
    every plan cache consults it on a miss and writes back after a build,
    and the graph caches note their new structures in it."""
    global _active_store
    store = resolve_store(store)
    _active_store = store
    _plan_mod._ACTIVE_STORE = store
    return store


def deactivate_store() -> None:
    """Flush the active store's records and detach it."""
    global _active_store
    if _active_store is not None:
        _active_store.flush()
    _active_store = None
    _plan_mod._ACTIVE_STORE = None


def active_store() -> Optional[PlanStore]:
    """The process-wide store, or None."""
    return _active_store


@contextlib.contextmanager
def using_store(store):
    """Scoped ``activate_store``: flushes, and restores the previous store
    on exit."""
    prev = _active_store
    s = activate_store(store)
    try:
        yield s
    finally:
        s.flush()
        if prev is None:
            deactivate_store()
        else:
            activate_store(prev)


def store_stats() -> Optional[Dict[str, Any]]:
    """``stats()`` of the active store, or None when none is attached."""
    return None if _active_store is None else _active_store.stats()


def resolve_store(store) -> Optional[PlanStore]:
    """None | path | PlanStore -> Optional[PlanStore]."""
    if store is None or isinstance(store, PlanStore):
        return store
    return PlanStore(store)


def note(record: Tuple, device) -> None:
    """Record a structure in the active store, if there is one."""
    if _active_store is not None:
        _active_store.note_structure(record, device)


# ------------------------------------------------------------------ warmup
def warmup(engine, store: Optional[PlanStore], device) -> Dict[str, Any]:
    """Capture every structure ``store`` records for ``device`` on
    ``engine`` (a ``ContractionEngine``), before a run sweeps.

    Matvec records of another engine configuration (backend, kernel) are
    skipped, and so is everything under an spmd policy, which captures no
    graph.  The operands are zeros of the recorded structures: a capture
    depends on shapes only, and the real operands are staged at each call.
    Returns the records replayed, the graph captures they took and the
    seconds.
    """
    store = store if store is not None else _active_store
    if store is None or getattr(engine, "_spmd_mode", False):
        return {}
    device = torch.device(device)
    t0 = time.perf_counter()
    captures0 = engine.graphs.captures
    replayed = 0
    for rec in store.structures(device):
        kind = rec[0]
        if kind == "matvec":
            _, backend, use_kernel, dtype, structs = rec
            if (backend, use_kernel) != (engine.backend, engine.use_kernel):
                continue
            A, Wj, Wj1, B, x = (zeros_of(s, getattr(torch, dtype), device) for s in structs)
            engine.matvec_fn(A, Wj, Wj1, B, jit=True)(x)
        elif kind == "env":
            _, side, dtype, structs = rec
            env, T, W = (zeros_of(s, getattr(torch, dtype), device) for s in structs)
            (engine.env.update_left if side == "left" else engine.env.update_right)(env, T, W, mpo_padded=W)
        elif kind == "svd":
            _, dtype, shape = rec
            torch.linalg.svd(torch.ones(shape, dtype=getattr(torch, dtype), device=device), full_matrices=False)
        else:
            continue
        replayed += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"records": replayed, "captures": engine.graphs.captures - captures0,
            "seconds": time.perf_counter() - t0}
