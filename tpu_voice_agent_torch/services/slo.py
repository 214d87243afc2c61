"""Rolling-window SLO evaluation: the latency budget and the quality floors.

Port of ``tpu_voice_agent/utils/slo.py``:

- ``SLOTracker``: a service records each request's latency and outcome, and
  ``evaluate`` grades the window ``ok``, ``at_risk`` (a percentile past
  ``SLO_AT_RISK_FRACTION`` of its target) or ``violated``, and exports it
  as the ``slo.<name>.*`` gauges of the process-global registry.
- ``QualityTracker``: bounded windows of per-utterance quality signals held
  to floors and ceilings (``slo.<name>.state`` in the registry it is given).

The ok -> violated edge of either kind of tracker freezes the flight
recorder (``slo.<name>.violated``; a quality violation carries the failing
samples' details under ``extra.quality``). A ``passive`` ``SLOTracker`` (a
measurement-side verdict) exports nothing and freezes nothing.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ..utils.tracing import get_flight_recorder, get_metrics, nearest_rank

STATES = ("ok", "at_risk", "violated")

# how often record() re-evaluates the window on its own (seconds), so the
# gauges follow the sample stream, not only the scrapes
AUTO_EVAL_S = 1.0


class SLOTracker:
    """Thread-safe rolling window of (timestamp, latency_ms, ok) samples.

    Env defaults (overridable per instance): ``SLO_WINDOW_S`` (300),
    ``SLO_TARGET_P50_MS`` (800), ``SLO_TARGET_P99_MS`` (4x the p50 target),
    ``SLO_ERROR_RATE`` (0.05), ``SLO_AT_RISK_FRACTION`` (0.8),
    ``SLO_MIN_SAMPLES`` (5: below it the verdict stays ``ok``).
    ``passive=True``: a pure evaluator that exports no gauge and freezes
    nothing (a scoring loop must not mutate the system it scores)."""

    MAX_SAMPLES = 8192  # hard cap independent of the window (memory bound)

    def __init__(self, name: str, *, window_s: float | None = None,
                 target_p50_ms: float | None = None, target_p99_ms: float | None = None,
                 error_rate_target: float | None = None,
                 at_risk_fraction: float | None = None, min_samples: int | None = None,
                 clock=time.monotonic, passive: bool = False):
        env = os.environ.get
        self.name = name
        self.passive = passive
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
        self._last_state = "ok"
        self._last_auto_eval = 0.0

    def record(self, latency_ms: float, ok: bool = True) -> None:
        with self._lock:
            self._samples.append((self._clock(), float(latency_ms), bool(ok)))
            due = self._clock() - self._last_auto_eval >= AUTO_EVAL_S
            if due:
                self._last_auto_eval = self._clock()
        if due:
            self.evaluate()  # outside the lock: it takes the lock again

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
        if not self.passive:
            # the ok / at_risk -> violated edge is the incident: freeze the
            # flight recorder at its onset
            prev, self._last_state = self._last_state, state
            if state == "violated" and prev != "violated":
                get_flight_recorder().trigger(f"slo.{self.name}.violated",
                                              detail="; ".join(reasons))
            m = get_metrics()
            m.set_gauge(f"slo.{self.name}.state", float(STATES.index(state)))
            m.set_gauge(f"slo.{self.name}.window_samples", float(n))
            m.set_gauge(f"slo.{self.name}.error_rate", error_rate)
            if p50 is not None:
                m.set_gauge(f"slo.{self.name}.p50_ms", p50)
            if p99 is not None:
                m.set_gauge(f"slo.{self.name}.p99_ms", p99)
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


class QualityTracker:
    """The quality dimension of the SLO plane: rolling windows of
    per-utterance quality signals held to floors / ceilings. Each signal
    keeps a bounded window of (value, detail) samples; a windowed mean under
    its floor (or over its ceiling), over at least ``min_samples`` samples,
    grades the tracker ``violated``. A floor or ceiling of 0 (or None) is
    disarmed. ``metrics`` defaults to the process-global registry."""

    MAX_SAMPLES = 1024

    def __init__(self, name: str = "quality", *, floors: dict[str, float] | None = None,
                 ceilings: dict[str, float] | None = None, window: int | None = None,
                 min_samples: int | None = None, metrics=None, clock=time.monotonic):
        self.name = name
        self.floors = {k: v for k, v in (floors or {}).items() if v is not None and v > 0}
        self.ceilings = {k: v for k, v in (ceilings or {}).items() if v is not None and v > 0}
        self.window = window if window is not None \
            else int(os.environ.get("QUALITY_WINDOW", "64"))
        self.min_samples = min_samples if min_samples is not None \
            else int(os.environ.get("QUALITY_SLO_MIN_SAMPLES", "5"))
        self._metrics = metrics if metrics is not None else get_metrics()
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: dict[str, deque] = {}
        self._last_state = "ok"
        self._last_auto_eval = 0.0

    def record(self, signal: str, value: float, detail: dict | None = None) -> None:
        """One utterance's reading for ``signal``; ``detail`` is its quality
        vector (transcript preview, margins, scores), the evidence a violated
        verdict lists."""
        with self._lock:
            dq = self._samples.get(signal)
            if dq is None:
                dq = self._samples[signal] = deque(maxlen=min(self.window, self.MAX_SAMPLES))
            dq.append((float(value), detail))
            due = self._clock() - self._last_auto_eval >= AUTO_EVAL_S
            if due:
                self._last_auto_eval = self._clock()
        if due:
            self.evaluate()

    def means(self) -> dict[str, float]:
        with self._lock:
            return {sig: sum(v for v, _ in dq) / len(dq) for sig, dq in self._samples.items() if dq}

    def state(self) -> str:
        return self.evaluate()["state"]

    def evaluate(self) -> dict:
        """Grade every armed signal; export ``slo.<name>.state``."""
        with self._lock:
            snap = {sig: list(dq) for sig, dq in self._samples.items()}
        state = "ok"
        reasons: list[str] = []
        evidence: dict[str, dict] = {}
        signals: dict[str, dict] = {}
        for sig, xs in snap.items():
            mean = sum(v for v, _ in xs) / len(xs) if xs else None
            entry = {"samples": len(xs), "mean": round(mean, 4) if mean is not None else None}
            floor = self.floors.get(sig)
            ceiling = self.ceilings.get(sig)
            if floor is not None:
                entry["floor"] = floor
            if ceiling is not None:
                entry["ceiling"] = ceiling
            bad = None
            if mean is not None and len(xs) >= self.min_samples:
                if floor is not None and mean < floor:
                    bad = f"{sig} {mean:.3g} < floor {floor:.3g}"
                elif ceiling is not None and mean > ceiling:
                    bad = f"{sig} {mean:.3g} > ceiling {ceiling:.3g}"
            if bad is not None:
                state = "violated"
                reasons.append(bad)
                # the failing utterances' quality vectors ride the freeze
                evidence[sig] = {"mean": round(mean, 4), "floor": floor, "ceiling": ceiling,
                                 "recent": [{"value": round(v, 4), **(d or {})}
                                            for v, d in xs[-8:]]}
            signals[sig] = entry
        prev, self._last_state = self._last_state, state
        if state == "violated" and prev != "violated":
            get_flight_recorder().trigger(f"slo.{self.name}.violated", detail="; ".join(reasons),
                                          extra={"quality": evidence})
        self._metrics.set_gauge(f"slo.{self.name}.state", float(STATES.index(state)))
        return {"name": self.name, "state": state, "reasons": reasons, "signals": signals}
