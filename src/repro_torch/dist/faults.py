"""The exceptions of the numerical-health contract.

``NumericalHealthError`` is raised by the isfinite guards that ride the
pipeline's existing host syncs (the Davidson Rayleigh-Ritz read, the
post-SVD singular-value sync), so health checking costs no extra device
round-trip.  ``FaultInjected`` is what an armed fault point raises; the
fault registry and its points are not ported yet, so nothing in the port
raises it today.
"""
from __future__ import annotations

from typing import Optional


class FaultInjected(RuntimeError):
    """An armed fault point fired in "raise" mode; ``point`` names it."""

    def __init__(self, point: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at {point!r}")
        self.point = point


class NumericalHealthError(RuntimeError):
    """A health guard at an existing host-sync point saw non-finite values.

    ``stage`` names the pipeline stage that detected it ("davidson", "svd").
    """

    def __init__(self, message: str, stage: str = ""):
        super().__init__(message)
        self.stage = stage
