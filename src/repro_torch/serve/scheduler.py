"""Batch scheduler: group requests by plan signature, cut power-of-two slots.

Requests land in per-group FIFO queues (one group per ``problems.group_key``
— model/size/solver settings + MPO structure).  ``next_batch`` serves the
group whose head request has waited longest (no starvation) and pads the
slot to the next power of two by duplicating the tail request, because the
pipeline's CUDA graphs are keyed by every padded structure INCLUDING the
batch size: a quantized slot-size set {1, 2, 4, ..., max_batch} means the
warmup hook can capture every size a steady-state batch will ever take, and
ragged arrival counts never capture again.  Filler copies cost compute but not
correctness — their results are dropped on completion.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

from ..dist.plan import bucket_dim


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """One DMRG request: model + Hamiltonian parameters + solver settings.

    ``params`` is a sorted tuple of (name, value) pairs (hashable, so specs
    can key dicts); use ``make`` to build one from kwargs.
    """

    model: str = "heisenberg"
    n_sites: int = 8
    params: Tuple[Tuple[str, float], ...] = ()
    max_bond: int = 16
    sweeps_per_bond: int = 2
    davidson_iters: int = 6
    cutoff: float = 1e-12
    mpo_cutoff: float = 1e-13

    @staticmethod
    def make(model: str = "heisenberg", n_sites: int = 8, **kw) -> "ProblemSpec":
        solver = {
            k: kw.pop(k)
            for k in ("max_bond", "sweeps_per_bond", "davidson_iters",
                      "cutoff", "mpo_cutoff")
            if k in kw
        }
        return ProblemSpec(
            model=model,
            n_sites=n_sites,
            params=tuple(sorted(kw.items())),
            **solver,
        )

    @property
    def bond_schedule(self) -> Tuple[int, ...]:
        """Power-of-two ramp 8, 16, ... up to ``max_bond`` (the bucket set
        the warmup hook captures), like the examples drivers use."""
        out: List[int] = []
        m = 8
        while m < self.max_bond:
            out.append(m)
            m *= 2
        out.append(self.max_bond)
        return tuple(out)

    # ------------------------------------------------------- journal (JSON)
    def to_json_dict(self) -> Dict:
        """Plain-JSON form, for the service's crash-recovery journal."""
        d = dataclasses.asdict(self)
        d["params"] = [[k, v] for k, v in self.params]
        return d

    @staticmethod
    def from_json_dict(d: Dict) -> "ProblemSpec":
        """Inverse of ``to_json_dict`` (JSON lists back to hashable tuples)."""
        d = dict(d)
        d["params"] = tuple((k, v) for k, v in d.get("params", ()))
        return ProblemSpec(**d)


@dataclasses.dataclass
class BatchSlot:
    """One schedulable batch: real requests + tail-duplicated filler."""

    key: Tuple                       # the group key
    rids: List[int]                  # request ids, real ones only
    specs: List[ProblemSpec]         # len == slot_size (fillers appended)
    mpos: List                       # per-problem MPOs, len == slot_size
    space: object

    @property
    def n_real(self) -> int:
        return len(self.rids)

    @property
    def slot_size(self) -> int:
        return len(self.specs)

    @property
    def fill_ratio(self) -> float:
        return self.n_real / self.slot_size

    def rid_at(self, b: int) -> int:
        """The request id batch position ``b`` belongs to.

        Filler positions (``b >= n_real``) are tail duplicates, so a
        per-problem failure mask flagging a filler implicates the tail
        request — its real copy shares the filler's values exactly.
        """
        return self.rids[b] if b < self.n_real else self.rids[-1]


def make_slot(key, rids, specs, space, mpos) -> BatchSlot:
    """Build a slot from real requests, padding to the power-of-two size.

    The same tail-duplication rule ``BatchScheduler.next_batch`` uses —
    shared so the service's bisection-retry slots land on the identical
    warmed batch-size buckets as scheduler-cut ones.
    """
    if not rids or not len(rids) == len(specs) == len(mpos):
        raise ValueError(f"a slot needs as many specs and MPOs as requests, got {len(rids)}, {len(specs)}, {len(mpos)}")
    specs, mpos = list(specs), list(mpos)
    slot = bucket_dim(len(rids))
    while len(specs) < slot:
        specs.append(specs[-1])
        mpos.append(mpos[-1])
    return BatchSlot(
        key=key, rids=list(rids), specs=specs, mpos=mpos, space=space
    )


class BatchScheduler:
    """Per-group FIFO queues with oldest-head-first slot cutting."""

    def __init__(self, max_batch: int = 8):
        if max_batch < 1:
            raise ValueError(f"max_batch must be at least 1, got {max_batch}")
        self.max_batch = max_batch
        self._queues: "OrderedDict[Tuple, Deque]" = OrderedDict()
        self._seq = itertools.count()

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def add(self, key: Tuple, rid: int, spec: ProblemSpec, space, mpo):
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        q.append((next(self._seq), rid, spec, space, mpo))

    def remove(self, rid: int) -> bool:
        """Drop a queued request (cancellation); False if not queued."""
        for key, q in list(self._queues.items()):
            for item in q:
                if item[1] == rid:
                    q.remove(item)
                    if not q:
                        del self._queues[key]
                    return True
        return False

    def oldest_seq(self) -> Optional[int]:
        """Arrival counter of the longest-waiting request (None if empty)."""
        heads = [q[0][0] for q in self._queues.values() if q]
        return min(heads) if heads else None

    def largest_group(self) -> int:
        return max((len(q) for q in self._queues.values()), default=0)

    def next_batch(self) -> Optional[BatchSlot]:
        """Cut a slot from the group whose head request is oldest."""
        best_key, best_seq = None, None
        for key, q in self._queues.items():
            if q and (best_seq is None or q[0][0] < best_seq):
                best_key, best_seq = key, q[0][0]
        if best_key is None:
            return None
        q = self._queues[best_key]
        taken = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        if not q:
            del self._queues[best_key]
        rids = [t[1] for t in taken]
        specs = [t[2] for t in taken]
        space = taken[0][3]
        mpos = [t[4] for t in taken]
        # pad to the power-of-two slot size with tail duplicates so the
        # captured pipeline only ever sees the warmed batch-size bucket set
        slot = bucket_dim(len(taken))
        while len(specs) < slot:
            specs.append(specs[-1])
            mpos.append(mpos[-1])
        return BatchSlot(key=best_key, rids=rids, specs=specs, mpos=mpos,
                        space=space)
