"""Rolling-window SLO evaluation for the voice->intent latency budget.

Port of ``SLOTracker`` from ``tpu_voice_agent/utils/slo.py``: the voice
service records each utterance's end-of-speech processing latency and
outcome, and ``/health`` reports the window's verdict, ``ok``, ``at_risk``
(a percentile past ``SLO_AT_RISK_FRACTION`` of its target) or ``violated``.
The port has no gauges and no flight recorder yet (ROADMAP.md Queue 1 items
3 and 7), so nothing is exported and no edge is acted on.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

STATES = ("ok", "at_risk", "violated")


def nearest_rank(sorted_xs, q: float):
    """Nearest-rank percentile on the interpolation index ``q * (n - 1)``,
    half-up (the JAX package's ``utils.tracing.nearest_rank``)."""
    n = len(sorted_xs)
    if n == 0:
        raise ValueError("no samples")
    idx = int(q * (n - 1) + 0.5)
    return sorted_xs[min(n - 1, max(0, idx))]


class SLOTracker:
    """Thread-safe rolling window of (timestamp, latency_ms, ok) samples.

    Env defaults (overridable per instance): ``SLO_WINDOW_S`` (300),
    ``SLO_TARGET_P50_MS`` (800), ``SLO_TARGET_P99_MS`` (4x the p50 target),
    ``SLO_ERROR_RATE`` (0.05), ``SLO_AT_RISK_FRACTION`` (0.8),
    ``SLO_MIN_SAMPLES`` (5: below it the verdict stays ``ok``)."""

    MAX_SAMPLES = 8192  # hard cap independent of the window (memory bound)

    def __init__(self, name: str, *, window_s: float | None = None,
                 target_p50_ms: float | None = None, target_p99_ms: float | None = None,
                 error_rate_target: float | None = None,
                 at_risk_fraction: float | None = None, min_samples: int | None = None,
                 clock=time.monotonic):
        env = os.environ.get
        self.name = name
        self.window_s = window_s if window_s is not None else float(env("SLO_WINDOW_S", "300"))
        self.target_p50_ms = target_p50_ms if target_p50_ms is not None \
            else float(env("SLO_TARGET_P50_MS", "800"))
        self.target_p99_ms = target_p99_ms if target_p99_ms is not None \
            else float(env("SLO_TARGET_P99_MS", str(self.target_p50_ms * 4)))
        self.error_rate_target = error_rate_target if error_rate_target is not None \
            else float(env("SLO_ERROR_RATE", "0.05"))
        self.at_risk_fraction = at_risk_fraction if at_risk_fraction is not None \
            else float(env("SLO_AT_RISK_FRACTION", "0.8"))
        self.min_samples = min_samples if min_samples is not None \
            else int(env("SLO_MIN_SAMPLES", "5"))
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: deque[tuple[float, float, bool]] = deque(maxlen=self.MAX_SAMPLES)

    def record(self, latency_ms: float, ok: bool = True) -> None:
        with self._lock:
            self._samples.append((self._clock(), float(latency_ms), bool(ok)))

    def _windowed(self) -> list[tuple[float, float, bool]]:
        cutoff = self._clock() - self.window_s
        with self._lock:
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            return list(self._samples)

    def state(self) -> str:
        return self.evaluate()["state"]

    def evaluate(self) -> dict:
        xs = self._windowed()
        lat = sorted(ms for _, ms, _ in xs)
        n = len(xs)
        errors = sum(1 for _, _, ok in xs if not ok)
        p50 = nearest_rank(lat, 0.50) if lat else None
        p99 = nearest_rank(lat, 0.99) if lat else None
        error_rate = errors / n if n else 0.0

        state = "ok"
        reasons: list[str] = []
        if n >= self.min_samples:
            for label, value, target in (("p50_ms", p50, self.target_p50_ms),
                                         ("p99_ms", p99, self.target_p99_ms),
                                         ("error_rate", error_rate, self.error_rate_target)):
                if value is None or target <= 0:
                    continue
                if value > target:
                    state = "violated"
                    reasons.append(f"{label} {value:.3g} > target {target:.3g}")
                elif value > target * self.at_risk_fraction and state == "ok":
                    state = "at_risk"
                    reasons.append(f"{label} {value:.3g} > "
                                   f"{self.at_risk_fraction:.0%} of target {target:.3g}")
        return {
            "name": self.name,
            "state": state,
            "reasons": reasons,
            "window_s": self.window_s,
            "samples": n,
            "errors": errors,
            "error_rate": round(error_rate, 4),
            "p50_ms": round(p50, 3) if p50 is not None else None,
            "p99_ms": round(p99, 3) if p99 is not None else None,
            "targets": {"p50_ms": self.target_p50_ms, "p99_ms": self.target_p99_ms,
                        "error_rate": self.error_rate_target},
        }
