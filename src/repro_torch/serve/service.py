"""Async serving front end: bounded queue, worker thread, stats endpoint.

``DMRGService`` accepts ``ProblemSpec`` requests (``submit`` -> request id),
solves them in structure-grouped batch slots on a daemon worker thread
through one shared ``StackedOps`` pipeline, and exposes ``poll`` /
``result`` plus a structured ``stats`` endpoint (problems/sec, batch fill
ratio, retraces, plan-cache hit rates, per-stage seconds).

Devices: the service solves on ``device`` (``None`` means the CUDA card,
raising when there is none; nothing falls back to the CPU).  ``submit``
builds each problem's MPO on the CPU, on the submitting thread; the worker
stacks the slot's MPOs and moves them to the card under ``DEVICE_LOCK``, so
no thread but the worker touches the card while it captures a graph.

Backpressure: the queue is bounded (``max_queue``); ``submit`` blocks up to
``timeout`` for a slot and then raises ``ServeQueueFull`` -- shedding load at
admission instead of growing an unbounded backlog.

Warmup: ``warmup(spec, sizes)`` runs one full solve per power-of-two slot
size OUTSIDE the serving ledger, building the plans and capturing every
graph (all bond-schedule structures x all slot sizes).  After that,
steady-state batches of the same structures replay captured graphs only --
``stats()['retraces']`` counts captures since the last warmup, and the CLI
``--check`` asserts it stays zero.  With a ``plan_store`` the warmup first
captures every structure the store records (``dist/persist.warmup``), and
its solves then load their plans from the store instead of building them;
what the warmup captured anew is written back to the store.

Robustness: a failed slot never takes healthy requests down with it.  A
``NumericalHealthError`` with a per-problem mask fails (or retries) exactly
the poisoned requests and re-runs the rest, whose energies match a clean
run (phantom batch slots carry exact zeros, so batch composition never
changes per-problem numerics).  An injected fault or health error without a
mask, or a slot of mixed block structure (``StructureMismatch``), bisects
the slot and retries each half -- O(log B) extra solves isolate one bad
request.  Every failed request carries a retry budget with exponential
backoff.  Any other error -- a block GEMM that does not build or launch, a
failed capture -- is neither retried nor bisected: it fails the slot's
requests at once, carrying the error, and counts in ``stats()
["unrecovered_errors"]``.  The worker thread is watchdogged: if it dies,
in-flight requests are re-enqueued and a fresh worker starts (capped
restarts).  Delivered results are EVICTED from the live table into a
bounded tombstone map -- the service's memory is O(in-flight + tombstones),
not O(lifetime requests).  With ``checkpoint_dir`` set, undelivered request
specs are journaled to disk (atomic JSON) and re-submitted on construction
after a process crash.
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import dist
from ..dist import persist
from ..device import resolve_device
from ..dist import faults
from ..dist.faults import RECOVERABLE, FaultInjected, NumericalHealthError
from ..tensor.blocksparse import BlockSparseTensor
from .multicore import StructureMismatch, run_dmrg_multi
from .problems import build_problem, group_key
from .scheduler import BatchScheduler, BatchSlot, ProblemSpec, make_slot
from .stacked import StackedOps


class ServeQueueFull(Exception):
    """Raised by ``submit`` when the bounded queue stays full past timeout."""


# A CUDA graph capture fails (and its graph with it) when another thread
# works on the card meanwhile.  The worker thread holds this lock for the
# duration of every batch solve (and warmup holds it per size); in-process
# clients that run their OWN work on the card while a service is live (e.g.
# verification solves) should hold it too.  RLock so a client can nest
# service calls under its own critical section.
DEVICE_LOCK = threading.RLock()


_PENDING, _RUNNING, _DONE, _FAILED, _CANCELLED = (
    "pending", "running", "done", "failed", "cancelled",
)

#: request-record keys never exposed through poll/result/tombstones (bulky
#: tensors held only for re-enqueue and bisection retry)
_INTERNAL_KEYS = ("space", "mpo", "key")

_JOURNAL_NAME = "serve_journal.json"
_JOURNAL_VERSION = 1


def _poison_mpo(mpo):
    """NaN-filled structural copy of one problem's MPO (fault payload)."""
    return [
        BlockSparseTensor(
            t.indices,
            {k: torch.full_like(b, float("nan")) for k, b in t.blocks.items()},
            t.charge,
        )
        for t in mpo
    ]


class DMRGService:
    """Batched DMRG serving: submit/poll/result over a worker thread.

    Parameters
    ----------
    max_batch: largest slot the scheduler cuts (slots pad to powers of two).
    max_queue: admission bound — queued-but-unsolved requests beyond this
        block/reject new submits.
    batch_wait_s: how long the worker waits for a partial group to fill
        before cutting an under-full slot (latency/throughput trade).
    ops: shared ``StackedOps``; pass one to share captured pipelines across
        services, default builds its own.
    start: launch the worker thread (tests set False to drive manually).
    max_retries: per-request retry budget — failed solo re-runs beyond this
        mark the request failed.
    retry_backoff_s: base backoff before a charged retry re-run, doubled
        per retry already spent on the request (0 disables sleeping).
    max_worker_restarts: watchdog cap; a worker death beyond this fails all
        in-flight requests instead of restarting again.
    max_tombstones: delivered/cancelled results kept for late ``poll``.
    checkpoint_dir: when set, undelivered request specs are journaled there
        (``serve_journal.json``, atomic rewrite) and re-submitted on the
        next construction with the same directory — completed-but-
        undelivered work is recomputed, which determinism makes exact.
    plan_store: a ``dist.PlanStore`` or a path, activated process-wide
        (``dist/persist.activate_store``): every plan cache loads from it and
        writes back to it, and ``warmup`` replays its structure records and
        flushes new ones (also at ``shutdown``).
    device: where slots are solved; None means the CUDA card (raising when
        there is none).
    """

    def __init__(
        self,
        max_batch: int = 8,
        max_queue: int = 64,
        batch_wait_s: float = 0.05,
        ops: Optional[StackedOps] = None,
        start: bool = True,
        max_retries: int = 2,
        retry_backoff_s: float = 0.0,
        max_worker_restarts: int = 5,
        max_tombstones: int = 256,
        checkpoint_dir: Optional[str] = None,
        plan_store=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.plan_store = persist.activate_store(plan_store) if plan_store is not None else None
        # what the store's warmup replayed before each warmup's solves
        self.store_warmups: List[Dict] = []
        self.ops = ops if ops is not None else StackedOps()
        self.scheduler = BatchScheduler(max_batch)
        self.max_queue = max_queue
        self.batch_wait_s = batch_wait_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_worker_restarts = max_worker_restarts
        self.max_tombstones = max_tombstones
        self.checkpoint_dir = checkpoint_dir
        self._cv = threading.Condition()
        self._requests: Dict[int, Dict] = {}
        self._delivered: "OrderedDict[int, Dict]" = OrderedDict()
        self._rid = itertools.count()
        self._stop = False
        # serving ledger (warmup excluded)
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.retries = 0
        self.bisections = 0
        self.worker_restarts = 0
        self.solve_seconds = 0.0
        self.slots_run = 0
        self.fill_sum = 0.0
        # slots failed by an error no recovery handles (a kernel build or
        # launch error): zero in a healthy run
        self.unrecovered_errors = 0
        self.stage_seconds = {"davidson": 0.0, "svd": 0.0, "env": 0.0}
        # Davidson health aggregates over served slots (real problems only)
        self.davidson_health = {
            "solves": 0, "converged": 0, "iterations": 0, "restarts": 0,
        }
        self._retrace_floor = self.ops.retraces
        self._warmed: set = set()
        self._worker: Optional[threading.Thread] = None
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            self._recover_journal()
        if start:
            self._start_worker()

    def _start_worker(self):
        self._worker = threading.Thread(target=self._worker_loop, name="dmrg-serve", daemon=True)
        self._worker.start()

    # ----------------------------------------------------------------- client
    def submit(self, spec: ProblemSpec, timeout: Optional[float] = None) -> int:
        """Enqueue a problem; returns a request id.

        Builds the MPO on the calling thread (on the CPU: host-only work,
        safe while the worker captures), derives the batch group, and admits
        the request unless the queue is full past ``timeout``.
        """
        space, mpo = build_problem(spec)
        key = group_key(spec, mpo)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while len(self.scheduler) >= self.max_queue:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise ServeQueueFull(
                        f"queue full ({self.max_queue} pending) after "
                        f"{timeout}s"
                    )
                if not self._cv.wait(timeout=remaining):
                    raise ServeQueueFull(
                        f"queue full ({self.max_queue} pending) after "
                        f"{timeout}s"
                    )
            rid = next(self._rid)
            self._requests[rid] = {
                "status": _PENDING,
                "spec": spec,
                "submitted": time.monotonic(),
                "retries": 0,
                # held for re-enqueue after a worker death and for
                # bisection-retry slot rebuilds; never exposed to clients
                "space": space,
                "mpo": mpo,
                "key": key,
            }
            self.scheduler.add(key, rid, spec, space, mpo)
            self._journal_sync()
            self._cv.notify_all()
        return rid

    def _public(self, req: Dict) -> Dict:
        return {k: v for k, v in req.items() if k not in _INTERNAL_KEYS}

    def poll(self, rid: int) -> Dict:
        """Non-blocking status: {status, and result fields once done}.

        Delivered (and cancelled) requests answer from the bounded
        tombstone map; only ids evicted past ``max_tombstones`` raise.
        """
        with self._cv:
            req = self._requests.get(rid)
            if req is not None:
                return self._public(req)
            tomb = self._delivered.get(rid)
            if tomb is not None:
                return dict(tomb)
            raise KeyError(f"unknown request id {rid}")

    def result(self, rid: int, timeout: Optional[float] = None) -> Dict:
        """Block until ``rid`` completes; returns the result record.

        Delivery EVICTS the request from the live table into the tombstone
        map (fixing the delivered-result leak: a long-lived service no
        longer accumulates every result it ever produced).  A repeated
        ``result``/``poll`` for a recently delivered id still answers.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                req = self._requests.get(rid)
                if req is None:
                    tomb = self._delivered.get(rid)
                    if tomb is None:
                        raise KeyError(f"unknown request id {rid}")
                    if tomb["status"] == _DONE:
                        return dict(tomb)
                    raise RuntimeError(
                        f"request {rid} {tomb['status']}: "
                        f"{tomb.get('error', '')}"
                    )
                if req["status"] == _DONE:
                    rec = self._public(req)
                    self._evict(rid)
                    return rec
                if req["status"] == _FAILED:
                    err = req["error"]
                    self._evict(rid)
                    raise RuntimeError(f"request {rid} failed: {err}")
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"request {rid} not done after {timeout}s")
                self._cv.wait(timeout=remaining)

    def cancel(self, rid: int) -> bool:
        """Cancel a still-pending request; False once running or finished.

        A running slot cannot be interrupted mid-solve (the batch
        is already on the device), so cancellation is admission-queue only —
        the honest contract, not a best-effort lie.
        """
        with self._cv:
            req = self._requests.get(rid)
            if req is None or req["status"] != _PENDING:
                return False
            self.scheduler.remove(rid)
            req["status"] = _CANCELLED
            self.cancelled += 1
            self._evict(rid)
            self._cv.notify_all()
            return True

    def _evict(self, rid: int) -> None:
        """Move a finished request to the bounded tombstone map (cv held)."""
        req = self._requests.pop(rid, None)
        if req is None:
            return
        self._delivered[rid] = self._public(req)
        while len(self._delivered) > self.max_tombstones:
            self._delivered.popitem(last=False)
        self._journal_sync()

    # ---------------------------------------------------------------- journal
    def _journal_path(self) -> str:
        return os.path.join(self.checkpoint_dir, _JOURNAL_NAME)

    def _journal_sync(self) -> None:
        """Atomically rewrite the undelivered-request journal (cv held).

        Journaled: every live request that has not been delivered —
        pending, running, and done-but-unfetched (results are not
        persisted, so recovery recomputes them; determinism makes the
        recomputation exact).
        """
        if self.checkpoint_dir is None:
            return
        entries = [
            [rid, req["spec"].to_json_dict(), req["status"]]
            for rid, req in sorted(self._requests.items())
            if req["status"] in (_PENDING, _RUNNING, _DONE)
        ]
        payload = {"version": _JOURNAL_VERSION, "requests": entries}
        fd, tmp = tempfile.mkstemp(
            dir=self.checkpoint_dir, prefix=".journal_", suffix=".json"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self._journal_path())
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _recover_journal(self) -> None:
        """Re-submit journaled requests from a previous process (same rids)."""
        try:
            with open(self._journal_path()) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        if payload.get("version") != _JOURNAL_VERSION:
            return
        max_rid = -1
        for rid, spec_dict, _status in payload.get("requests", []):
            rid = int(rid)
            spec = ProblemSpec.from_json_dict(spec_dict)
            space, mpo = build_problem(spec)
            key = group_key(spec, mpo)
            self._requests[rid] = {
                "status": _PENDING,
                "spec": spec,
                "submitted": time.monotonic(),
                "retries": 0,
                "recovered": True,
                "space": space,
                "mpo": mpo,
                "key": key,
            }
            self.scheduler.add(key, rid, spec, space, mpo)
            max_rid = max(max_rid, rid)
        self._rid = itertools.count(max_rid + 1)

    # ----------------------------------------------------------------- warmup
    def warmup(self, spec, sizes: Sequence[int] = (1, 2, 4, 8)):
        """Capture the full pipeline for ``spec``'s group at each slot size.

        Runs one complete solve per size with ``size`` copies of ``spec`` —
        covering every bond-schedule structure at every power-of-two batch
        size the scheduler can cut — outside the serving ledger.  After this,
        requests in the group whose solves meet the same padded structures
        replay captured graphs only.

        ``spec`` may also be a sequence of specs of one group: each size's
        solve then takes them in turn (cyclically) as its problems.  A slot
        bonds its problems to the union of their truncated sectors, so a
        scan of parameters that truncates (bond below the full space) meets
        other padded structures than one problem copied; warming with the
        scan's own problems captures those.  Returns the warmup solves'
        ``MultiDMRGResult`` per size, in ascending size order.
        """
        specs = [spec] if isinstance(spec, ProblemSpec) else list(spec)
        built = [build_problem(s) for s in specs]
        keys = {group_key(s, mpo) for s, (_, mpo) in zip(specs, built)}
        if len(keys) != 1:
            raise ValueError(f"warmup specs span {len(keys)} batch groups; warm each group on its own")
        space, first = built[0][0], specs[0]
        sizes = sorted({s for s in sizes if s <= max(1, self.scheduler.max_batch)})
        if self.plan_store is not None:
            with DEVICE_LOCK:
                self.store_warmups.append(persist.warmup(self.ops.engine, self.plan_store, self.device))
        results = []
        for size in sizes:
            with DEVICE_LOCK:
                results.append(run_dmrg_multi(
                    space,
                    first.n_sites,
                    [built[b % len(built)][1] for b in range(size)],
                    bond_schedule=first.bond_schedule,
                    sweeps_per_bond=first.sweeps_per_bond,
                    cutoff=first.cutoff,
                    davidson_iters=first.davidson_iters,
                    ops=self.ops,
                    device=self.device,
                ))
        if self.plan_store is not None:
            self.plan_store.flush()
        with self._cv:
            self._warmed.add((keys.pop(), tuple(sizes)))
            self._retrace_floor = self.ops.retraces
        return results

    # ----------------------------------------------------------------- worker
    def _worker_loop(self):
        try:
            self._worker_body()
        except BaseException as exc:
            self._on_worker_death(exc)

    def _worker_body(self):
        while True:
            with self._cv:
                while not self._stop:
                    oldest = self.scheduler.oldest_seq()
                    if oldest is None:
                        self._cv.wait()
                        continue
                    # cut immediately once a full slot is available; give a
                    # partial group batch_wait_s to fill before running ragged
                    if self.scheduler.largest_group() >= self.scheduler.max_batch:
                        break
                    first = self._requests[
                        min(
                            (r for r, q in self._requests.items()
                             if q["status"] == _PENDING),
                            key=lambda r: self._requests[r]["submitted"],
                        )
                    ]
                    wait = self.batch_wait_s - (
                        time.monotonic() - first["submitted"]
                    )
                    if wait <= 0:
                        break
                    self._cv.wait(timeout=wait)
                if self._stop:
                    return
                slot = self.scheduler.next_batch()
                if slot is None:
                    continue
                for rid in slot.rids:
                    self._requests[rid]["status"] = _RUNNING
                self._journal_sync()
                self._cv.notify_all()  # queue drained below max -> admit more
            # fault point: kill the worker thread BETWEEN marking requests
            # running and solving — outside the per-slot recovery, so only
            # the watchdog (re-enqueue + restart) can save the in-flight work
            if faults.fire("serve.worker_crash") is not None:
                raise FaultInjected("serve.worker_crash")
            self._run_slot(slot)

    def _on_worker_death(self, exc: BaseException):
        """Watchdog: re-enqueue in-flight work, restart the worker (capped)."""
        restart = False
        with self._cv:
            if self._stop:
                return
            self.worker_restarts += 1
            restart = self.worker_restarts <= self.max_worker_restarts
            for rid, req in list(self._requests.items()):
                if req["status"] != _RUNNING:
                    continue
                if restart:
                    # never delivered anything for these; solving them again
                    # is exact (determinism), so re-enqueue is safe
                    req["status"] = _PENDING
                    req["submitted"] = time.monotonic()
                    self.scheduler.add(
                        req["key"], rid, req["spec"], req["space"], req["mpo"]
                    )
                else:
                    self.failed += 1
                    req.update(
                        status=_FAILED,
                        error=(
                            f"worker died {self.worker_restarts} times "
                            f"(cap {self.max_worker_restarts}): {exc!r}"
                        ),
                    )
            self._journal_sync()
            self._cv.notify_all()
        if restart:
            self._start_worker()

    # ------------------------------------------------------------- slot solve
    def _run_slot(self, slot: BatchSlot):
        # fault point: artificial latency (value = seconds), e.g. a slow node
        f = faults.fire("serve.slot_latency")
        if f is not None and f.value > 0:
            time.sleep(float(f.value))
        mpos = slot.mpos
        # fault point: NaN-poison the MPO of ONE request (problem = rid) in
        # a local copy — retries rebuild from the pristine stored MPO, so a
        # count=1 fault is transient and a count=inf fault follows the rid
        # through bisection, exactly like a corrupted upstream input would
        fp = faults.fire("serve.poison_request")
        if fp is not None:
            target = int(fp.problem)
            mpos = [
                _poison_mpo(m) if slot.rid_at(b) == target else m
                for b, m in enumerate(mpos)
            ]
        spec = slot.specs[0]
        t0 = time.perf_counter()
        try:
            with DEVICE_LOCK:
                res = run_dmrg_multi(
                    slot.space,
                    spec.n_sites,
                    mpos,
                    bond_schedule=spec.bond_schedule,
                    sweeps_per_bond=spec.sweeps_per_bond,
                    cutoff=spec.cutoff,
                    davidson_iters=spec.davidson_iters,
                    ops=self.ops,
                    device=self.device,
                )
        except NumericalHealthError as exc:
            if exc.problems is not None:
                self._retry_masked(slot, np.asarray(exc.problems, bool), exc)
            else:
                self._retry_split(slot, exc)
            return
        except RECOVERABLE + (StructureMismatch,) as exc:
            self._retry_split(slot, exc)
            return
        except Exception as exc:
            # a kernel that does not build or launch, a failed capture: a
            # retry or a bisection would meet it again, so the slot fails
            self._fail_slot(slot, exc)
            return
        dt = time.perf_counter() - t0
        last = res.sweep_stats[-1]
        with self._cv:
            self.solve_seconds += dt
            self.slots_run += 1
            self.fill_sum += slot.fill_ratio
            for st in res.sweep_stats:
                self.stage_seconds["davidson"] += st.davidson_seconds
                self.stage_seconds["svd"] += st.svd_seconds
                self.stage_seconds["env"] += st.env_seconds
                self.davidson_health["solves"] += st.davidson_solves
                self.davidson_health["iterations"] += st.davidson_iterations
                self.davidson_health["restarts"] += st.davidson_restarts
                if st.davidson_converged is not None:
                    self.davidson_health["converged"] += int(
                        st.davidson_converged[: slot.n_real].sum()
                    )
            for b, rid in enumerate(slot.rids):  # fillers beyond rids dropped
                req = self._requests.get(rid)
                if req is None or req["status"] != _RUNNING:
                    continue  # raced with cancellation
                self.completed += 1
                req.update(
                    status=_DONE,
                    energy=float(res.energies[b]),
                    max_bond=int(last.max_bond),
                    trunc_err=float(last.trunc_err[b]),
                    n_sweeps=len(res.sweep_stats),
                    batch_size=slot.slot_size,
                )
            self._journal_sync()
            self._cv.notify_all()

    def _fail_slot(self, slot: BatchSlot, exc: Exception):
        """Fail every running request of the slot at once, carrying ``exc``."""
        with self._cv:
            self.unrecovered_errors += 1
            for rid in slot.rids:
                req = self._requests.get(rid)
                if req is None or req["status"] != _RUNNING:
                    continue
                self.failed += 1
                req.update(status=_FAILED, error=repr(exc))
            self._journal_sync()
            self._cv.notify_all()

    # --------------------------------------------------------- slot recovery
    def _retry_masked(
        self, slot: BatchSlot, mask: np.ndarray, exc: NumericalHealthError
    ):
        """Per-problem isolation: fail/retry flagged requests, re-run the rest.

        The [B] mask pinpoints the poisoned batch positions (filler
        positions implicate the tail request they duplicate).  Healthy
        requests are re-run together WITHOUT charging their retry budget —
        they were victims — and phantom-slot exactness guarantees their
        re-run energies match a clean run bit-for-bit.
        """
        bad_rids = sorted({slot.rid_at(b) for b in np.flatnonzero(mask)})
        good: List[int] = [r for r in slot.rids if r not in bad_rids]
        by_rid = {rid: (slot.specs[b], slot.mpos[b])
                  for b, rid in enumerate(slot.rids)}
        for rid in bad_rids:
            self._charge_retry(rid, slot.key, by_rid[rid], slot.space, exc)
        if good:
            self._run_slot(make_slot(
                slot.key,
                good,
                [by_rid[r][0] for r in good],
                slot.space,
                [by_rid[r][1] for r in good],
            ))

    def _retry_split(self, slot: BatchSlot, exc: Exception):
        """Unmasked failure: bisect the slot, retry halves; singles charge
        the retry budget.  O(log B) extra solves isolate one bad request."""
        if slot.n_real > 1:
            with self._cv:
                self.bisections += 1
            mid = slot.n_real // 2
            for lo, hi in ((0, mid), (mid, slot.n_real)):
                self._run_slot(make_slot(
                    slot.key,
                    slot.rids[lo:hi],
                    slot.specs[lo:hi],
                    slot.space,
                    slot.mpos[lo:hi],
                ))
            return
        rid = slot.rids[0]
        self._charge_retry(
            rid, slot.key, (slot.specs[0], slot.mpos[0]), slot.space, exc
        )

    def _charge_retry(self, rid, key, spec_mpo, space, exc):
        """Spend one unit of ``rid``'s retry budget on a solo re-run."""
        spec, mpo = spec_mpo
        with self._cv:
            req = self._requests.get(rid)
            if req is None or req["status"] != _RUNNING:
                return  # cancelled or already resolved elsewhere
            req["retries"] += 1
            self.retries += 1
            if req["retries"] > self.max_retries:
                self.failed += 1
                req.update(status=_FAILED, error=repr(exc))
                self._journal_sync()
                self._cv.notify_all()
                return
            backoff = self.retry_backoff_s * (2 ** (req["retries"] - 1))
        if backoff > 0:
            time.sleep(backoff)
        self._run_slot(make_slot(key, [rid], [spec], space, [mpo]))

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict:
        """Structured serving stats (the ``--stats-json`` payload).

        ``retraces`` counts pipeline (re)traces since the last warmup — the
        steady-state number a warmed group must keep at zero.  Plan-cache
        hit rates come from ``repro.dist.cache_stats`` (the three global
        caches are shared with any in-process single-problem runs).
        ``retries``/``bisections``/``worker_restarts`` are the recovery
        ledger and ``ladders`` the engine's (contraction and SVD retries and
        degradations) — all zero on a healthy run; ``unrecovered_errors``
        counts slots failed by an error no recovery handles (zero on a
        healthy run); ``davidson`` aggregates per-solve health (solves,
        per-problem residual convergences, iterations, breakdown restarts)
        and ``faults`` reports what injection points are armed/fired.
        ``retraces`` are ``StackedOps.retraces``: graph captures (on the
        CPU, first eager runs of a graph key).
        """
        engine = self.ops.engine.stats()
        with self._cv:
            return {
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "pending": len(self.scheduler),
                "delivered_tombstones": len(self._delivered),
                "solve_seconds": self.solve_seconds,
                "problems_per_sec": (
                    self.completed / self.solve_seconds
                    if self.solve_seconds > 0 else 0.0
                ),
                "slots": self.slots_run,
                "batch_fill_ratio": (
                    self.fill_sum / self.slots_run if self.slots_run else 0.0
                ),
                "retries": self.retries,
                "bisections": self.bisections,
                "worker_restarts": self.worker_restarts,
                "unrecovered_errors": self.unrecovered_errors,
                "ladders": {
                    "retries": engine["retries"],
                    "degradations": engine["degradations"],
                    "svd_retries": engine["decomp"]["retries"],
                    "svd_degradations": engine["decomp"]["degradations"],
                },
                "retraces": self.ops.retraces - self._retrace_floor,
                "retraces_total": self.ops.retraces,
                "warmed_groups": len(self._warmed),
                "stage_seconds": dict(self.stage_seconds),
                "davidson": dict(self.davidson_health),
                "faults": faults.registry.stats(),
                "plan_caches": dist.cache_stats(self.ops.engine),
                "plan_store_warmups": list(self.store_warmups),
                "device": str(self.device),
            }

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10)
        if self.plan_store is not None:
            self.plan_store.flush()
