"""Deterministic fault injection and the numerical-health exceptions.

Failures are routine at scale: a batched GEMM can produce NaN on a flaky
card, the SVD can fail to converge, a run can be killed mid-sweep.  This
module makes those failure modes code paths that tests can reach:

- A registry of named **fault points** threaded through the pipeline
  (``FAULT_POINTS`` below).  Each point is a one-line hook at the real code
  site: ``fire("decomp.svd_fail")`` returns the armed fault (or ``None``).
  Disarmed, a hook is one truthiness check of an empty dict.
- Faults are **deterministic**: armed with ``after`` (skip the first N
  reaches) and ``count`` (fire at most N times), so a test can fail exactly
  the 3rd environment update of a run and nothing else.
- Arming: programmatically (``registry.arm`` / the ``inject`` context
  manager) or through the ``REPRO_FAULTS`` environment variable, e.g.::

      REPRO_FAULTS="decomp.svd_fail:count=1,sweep.kill:after=3"

  parsed at the registry's first use (the first ``fire`` or ``arm``), so it
  works for any entry point without code changes.

A hook fires on the host and never inside a CUDA graph capture: a fault
captured into a graph would replay far beyond its lifetime.

The exception types live here too, because the injection points and the
health guards that catch their damage are two halves of one contract:

- ``FaultInjected`` is raised by "raise"-style fault points.
- ``NumericalHealthError`` is raised by the isfinite guards that ride the
  pipeline's existing host syncs (the Davidson Rayleigh-Ritz read, the
  post-SVD singular-value sync), so health checking costs no extra
  device round-trip.

This registry belongs to this package: arming a point of the reference
package's registry does not arm the port's.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional


class FaultInjected(RuntimeError):
    """An armed fault point fired in "raise" mode; ``point`` names it."""

    def __init__(self, point: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at {point!r}")
        self.point = point


class NumericalHealthError(RuntimeError):
    """A health guard at an existing host-sync point saw non-finite values.

    ``stage`` names the pipeline stage that detected it ("davidson", "svd"),
    usually downstream of where the damage occurred.  ``problems`` is
    ``None`` for a single problem; for a stacked batch it is a boolean
    numpy array ``[B]``, True where that problem's values were non-finite.
    """

    def __init__(self, message: str, stage: str = "", problems=None):
        super().__init__(message)
        self.stage = stage
        self.problems = problems


#: What a degradation ladder recovers from: an injected fault or a health
#: guard's finding.  Any other exception (a kernel that does not build or
#: launch on a CUDA tensor, a failed graph capture, a CUDA error) propagates,
#: so no rung ever runs the plain version in place of a failing kernel.
RECOVERABLE = (FaultInjected, NumericalHealthError)


#: Every named injection point, with where its hook lives.  Arming an
#: unknown name raises at once (a typo would otherwise never fire and the
#: test would pass vacuously).
FAULT_POINTS: Dict[str, str] = {
    # NaN-poison one bucket output of a batched-GEMM contraction
    # (dist/batch.py execute_batched; skipped inside a CUDA graph capture).
    "batch.gemm_nan": "dist/batch.py:execute_batched",
    # Forced failure of the planned batched SVD, standing in for cuSOLVER
    # non-convergence (dist/decomp.py DecompositionEngine.svd_split).
    "decomp.svd_fail": "dist/decomp.py:DecompositionEngine.svd_split",
    # Exception out of the fused environment update, before its graph runs
    # (dist/envcore.py EnvironmentEngine._update).
    "env.exception": "dist/envcore.py:EnvironmentEngine._update",
    # Force a Davidson solve to report non-convergence: the residual break
    # is suppressed, the solve runs its full budget and returns
    # converged=False (core/davidson.py).
    "davidson.no_converge": "core/davidson.py:davidson",
    # Kill the sweep after a site update: a mid-sweep crash for the
    # checkpoint/resume path (core/sweep.py DMRGEngine.sweep).
    "sweep.kill": "core/sweep.py:DMRGEngine.sweep",
    # Crash the serving worker thread between slots (outside the per-slot
    # recovery), exercising the watchdog restart (serve/service.py).
    "serve.worker_crash": "serve/service.py:_worker_loop",
    # Artificial latency added to one slot solve (``value`` = seconds).
    "serve.slot_latency": "serve/service.py:_run_slot",
    # NaN-poison the MPO of one request in a slot before solving
    # (``problem`` = the request id, so the poison follows the request
    # through bisection retries), exercising per-problem health masks and
    # slot bisection (serve/service.py).
    "serve.poison_request": "serve/service.py:_run_slot",
}


@dataclasses.dataclass
class ArmedFault:
    """One armed injection: its firing window and payload."""

    point: str
    after: int = 0          # skip the first ``after`` reaches
    count: float = 1        # then fire this many times (math.inf = forever)
    value: float = 0.0      # payload: latency seconds, poison value, ...
    problem: int = 0        # batch position, for per-problem faults
    fired: int = 0          # times this fault actually fired
    seen: int = 0           # times the hook was reached while armed


class FaultRegistry:
    """Thread-safe registry of armed faults; the module holds one instance.

    ``fire()`` on an empty registry is one truthiness check of
    ``self._armed`` without the lock (reading a dict's emptiness is atomic
    under the GIL, and arming is rare), so carrying the hooks costs nothing.
    ``from_env`` makes the registry arm itself from ``REPRO_FAULTS`` at its
    first use.
    """

    def __init__(self, from_env: bool = False):
        self._armed: Dict[str, ArmedFault] = {}
        self._lock = threading.Lock()
        self._fired_total: Dict[str, int] = {}
        self._env_pending = from_env

    def _parse_env_once(self) -> None:
        if self._env_pending:
            self._env_pending = False
            self.arm_from_env()

    # ------------------------------------------------------------------ arm
    def arm(self, point: str, *, after: int = 0, count: float = 1, value: float = 0.0,
            problem: int = 0) -> ArmedFault:
        self._parse_env_once()
        if point not in FAULT_POINTS:
            raise KeyError(f"unknown fault point {point!r}; known: {sorted(FAULT_POINTS)}")
        f = ArmedFault(point, after=after, count=count, value=value, problem=problem)
        with self._lock:
            self._armed[point] = f
        return f

    def disarm(self, point: str) -> None:
        with self._lock:
            self._armed.pop(point, None)

    def clear(self) -> None:
        self._env_pending = False
        with self._lock:
            self._armed.clear()

    # ----------------------------------------------------------------- fire
    def fire(self, point: str) -> Optional[ArmedFault]:
        """The hook call sites use: None when disarmed or outside the window.

        Deterministic: the ``after``/``count`` window is consumed in the
        order hooks are reached, which the single-threaded sweep makes
        reproducible.
        """
        if self._env_pending:
            self._parse_env_once()
        if not self._armed:  # fast path: nothing armed, no lock
            return None
        with self._lock:
            f = self._armed.get(point)
            if f is None:
                return None
            f.seen += 1
            if f.seen <= f.after or f.fired >= f.count:
                return None
            f.fired += 1
            self._fired_total[point] = self._fired_total.get(point, 0) + 1
            return f

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict:
        with self._lock:
            return {"armed": sorted(self._armed), "fired": dict(self._fired_total)}

    # ---------------------------------------------------------------- env
    def arm_from_env(self, spec: Optional[str] = None) -> None:
        """Arm from a ``REPRO_FAULTS``-style spec string.

        Grammar: comma-separated points, each optionally followed by
        colon-separated ``key=value`` knobs (keys: after, count, value,
        problem; ``count=inf`` fires forever)::

            decomp.svd_fail:count=1:after=2,sweep.kill:after=3
        """
        spec = os.environ.get("REPRO_FAULTS", "") if spec is None else spec
        for part in filter(None, (p.strip() for p in spec.split(","))):
            name, *kvs = part.split(":")
            kw: Dict[str, float] = {}
            for kv in kvs:
                k, _, v = kv.partition("=")
                if k not in ("after", "count", "value", "problem"):
                    raise ValueError(f"bad REPRO_FAULTS knob {kv!r} in {part!r}")
                kw[k] = math.inf if v == "inf" else float(v)
            self.arm(name, after=int(kw.get("after", 0)), count=kw.get("count", 1),
                     value=kw.get("value", 0.0), problem=int(kw.get("problem", 0)))


#: The process-wide registry every hook consults; it reads ``REPRO_FAULTS``
#: at its first use.
registry = FaultRegistry(from_env=True)


def fire(point: str) -> Optional[ArmedFault]:
    """Module-level hook (``faults.fire("...")`` at each call site)."""
    return registry.fire(point)


@contextmanager
def inject(point: str, **kw) -> Iterator[ArmedFault]:
    """Arm one fault for the duration of a ``with`` block, then disarm.

    The yielded ``ArmedFault`` exposes ``fired``, so a test can assert that
    the fault actually triggered.
    """
    f = registry.arm(point, **kw)
    try:
        yield f
    finally:
        registry.disarm(point)
