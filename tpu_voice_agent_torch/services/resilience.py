"""The request's time budget, as the JAX package's services carry it.

Port of ``Deadline`` and ``DEADLINE_HEADER`` from
``tpu_voice_agent/utils/resilience.py``: the remaining milliseconds travel
in the ``x-deadline-ms`` header, and a service answers a budget that has run
out with 503 ``{"error": "overloaded", "detail": "deadline_expired"}`` and
``Retry-After: 0`` before doing any work (the brain's ``/parse`` gate).
Carrying the deadline into the scheduler is not ported yet.
"""

from __future__ import annotations

import time

# remaining-budget propagation header: milliseconds left, clamped at 0
DEADLINE_HEADER = "x-deadline-ms"


class Deadline:
    """Absolute expiry on a monotonic clock, carried across hops as a
    remaining-milliseconds header (absolute wall times don't survive clock
    skew between hosts; remaining budgets do)."""

    __slots__ = ("_expires_at", "_clock")

    def __init__(self, budget_s: float, clock=time.monotonic):
        self._clock = clock
        self._expires_at = clock() + max(0.0, budget_s)

    @classmethod
    def from_headers(cls, headers, clock=time.monotonic) -> "Deadline | None":
        """Parse the propagated budget; None when the caller sent none or a
        value that is not a number (the caller then opts out of shedding)."""
        raw = headers.get(DEADLINE_HEADER)
        if raw is None:
            return None
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            return None
        return cls(ms / 1e3, clock=clock)

    @property
    def expired(self) -> bool:
        return self._clock() >= self._expires_at
