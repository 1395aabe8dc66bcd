"""Straggler and step-time anomaly monitoring.

In SPMD training a slow host stalls every collective, so stragglers manifest
as global step-time spikes.  The monitor keeps an EWMA + variance of step
times and flags anomalies; the trainer's policy on a flagged step is
(1) log it, (2) after ``evict_after`` consecutive anomalies, request a
checkpoint-and-restart (on a real cluster the scheduler would then cordon the
slow host; in-process we surface the signal).  The same monitor as the
reference's, in plain Python.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    seconds: float
    ewma: float
    threshold: float
    consecutive: int
    evict: bool


class StepMonitor:
    def __init__(self, alpha: float = 0.1, sigma_mult: float = 4.0,
                 warmup: int = 5, evict_after: int = 3):
        self.alpha = alpha
        self.sigma_mult = sigma_mult
        self.warmup = warmup
        self.evict_after = evict_after
        self.ewma: Optional[float] = None
        self.ewvar: float = 0.0
        self.n = 0
        self.consecutive = 0
        self.reports: List[StragglerReport] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, seconds: Optional[float] = None) -> Optional[StragglerReport]:
        if seconds is None:
            assert self._t0 is not None
            seconds = time.perf_counter() - self._t0
        self.n += 1
        if self.ewma is None:
            self.ewma = seconds
            return None
        thresh = self.ewma + self.sigma_mult * max(self.ewvar, 0.05 * self.ewma)
        is_anomaly = self.n > self.warmup and seconds > thresh
        if is_anomaly:
            self.consecutive += 1
            rep = StragglerReport(
                step=step, seconds=seconds, ewma=self.ewma, threshold=thresh,
                consecutive=self.consecutive,
                evict=self.consecutive >= self.evict_after,
            )
            self.reports.append(rep)
        else:
            self.consecutive = 0
            rep = None
        # only fold non-anomalous steps into the running stats
        if not is_anomaly:
            d = seconds - self.ewma
            self.ewma += self.alpha * d
            self.ewvar = (1 - self.alpha) * (self.ewvar + self.alpha * abs(d))
        return rep
