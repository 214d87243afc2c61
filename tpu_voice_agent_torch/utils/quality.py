"""Quality observatory: online per-utterance quality signals.

Port of ``tpu_voice_agent/utils/quality.py``, with JAX's names:

- STT confidence: the Whisper decode loop accumulates the sampled token's
  log-probability (sum, min, first) on the device beside the tokens
  (``serve.stt``); ``finalize_stt_ids`` folds one row into the transcript's
  ``logp_mean`` / ``logp_min`` / ``logp_first`` and the host-side
  ``repetition_score``. The voice service puts them on ``transcript_final``
  as ``confidence`` and records them here (``stt.confidence_*`` gauges).
- Intent confidence: the grammar-constrained decode tails (dense, paged,
  spec verify) accumulate the masked-logit margin and entropy of each
  decision and the grammar-forced count (``serve.engine._conf_stats``);
  ``conf_summary`` folds a request's lanes into ``GenerationResult.quality``
  and the brain answers its mean margin as ``x-intent-margin``.
- ``QualityMonitor``: the bounded per-signal windows behind the
  ``quality.*`` / ``stt.confidence_*`` gauges, the ``QualityTracker``
  verdict, ``GET /debug/quality`` and ``/health``'s ``quality`` block.
  ``record_golden`` takes the canary's scores; its JAX twin's
  ``record_exec`` (fed by the executor service, ROADMAP.md Queue 1 item 9)
  waits for its caller.
- ``GoldenCanary``: the golden-replay canary (``QUALITY_CANARY_S`` > 0, the
  brain's knob): a daemon thread replays ``QUALITY_CANARY_SLICE`` rotating
  golden cases through the live parser each interval unless the replica is
  busy (``busy_fn``), and scores them into ``record_golden``.

``QUALITY_ENABLE=0`` removes the device lanes; the tokens are the same
either way (the lanes only read values the step already computed).
"""

from __future__ import annotations

import os
import threading
from collections import deque

from ..services.slo import QualityTracker
from .tracing import get_metrics


def quality_lanes_enabled() -> bool:
    """THE one read of the device-lane switch (``QUALITY_ENABLE``, default
    on; engines read it at construction)."""
    return os.environ.get("QUALITY_ENABLE", "1").lower() in ("1", "true", "yes", "on")


def repetition_score(ids: list[int]) -> float:
    """1 - distinct/total over a final's token ids, in [0, 1]: healthy
    speech sits low, one token looped to the budget near 1."""
    if not ids:
        return 0.0
    return 1.0 - len(set(ids)) / len(ids)


def _knob_float(name: str, default: str) -> float:
    return float(os.environ.get(name, default))


class QualityMonitor:
    """Per-service quality signal aggregation: bounded per-signal windows,
    gauges on every record, and the quality-SLO verdict. ``metrics`` is the
    service's tracer-local registry where one exists (``tracer.metrics``)."""

    def __init__(self, service: str, metrics=None, window: int | None = None,
                 tracker: QualityTracker | None = None):
        self.service = service
        self.metrics = metrics if metrics is not None else get_metrics()
        self.window = window if window is not None \
            else int(os.environ.get("QUALITY_WINDOW", "64"))
        self.slo = tracker if tracker is not None else QualityTracker(
            "quality",
            floors={
                "golden_accuracy": _knob_float("QUALITY_SLO_GOLDEN_MIN", "0.7"),
                "exec_success_rate": _knob_float("QUALITY_SLO_EXEC_MIN", "0.5"),
                "intent_margin": _knob_float("QUALITY_SLO_MARGIN_MIN", "0"),
            },
            ceilings={"stt_repetition": _knob_float("QUALITY_SLO_REPETITION_MAX", "0.9")},
            window=self.window, metrics=self.metrics)
        self._lock = threading.Lock()
        self._win: dict[str, deque] = {}
        # structural counts mirrored into state() (the registry keeps the
        # monotonic copies)
        self._counts: dict[str, int] = {}
        # the contract counters exist from construction, at zero
        m = self.metrics
        m.inc("quality.parses", 0.0)
        m.inc("quality.stt_finals", 0.0)
        m.inc("quality.degraded_parses", 0.0)
        m.inc("quality.rule_fallbacks", 0.0)
        m.inc("quality.exec_ok", 0.0)
        m.inc("quality.exec_failed", 0.0)
        m.inc("quality.canary_runs", 0.0)
        m.inc("quality.canary_errors", 0.0)
        m.inc("quality.canary_skipped_busy", 0.0)

    def _push(self, signal: str, value: float) -> float:
        """Append to the signal's window; returns the window mean."""
        with self._lock:
            dq = self._win.get(signal)
            if dq is None:
                dq = self._win[signal] = deque(maxlen=self.window)
            dq.append(float(value))
            return sum(dq) / len(dq)

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
        self.metrics.inc(name, float(n))

    def record_stt(self, logp_mean: float | None, logp_min: float | None, repetition: float,
                   text: str = "", logp_first: float | None = None) -> None:
        """One final transcript's confidence vector (voice service)."""
        detail = {"signal": "stt", "text": text[:60], "repetition": round(repetition, 4)}
        if logp_mean is not None:
            detail["logp_mean"] = round(logp_mean, 4)
            self.metrics.set_gauge("stt.confidence_mean", self._push("stt_logp_mean", logp_mean))
        if logp_min is not None:
            self.metrics.set_gauge("stt.confidence_min", self._push("stt_logp_min", logp_min))
        if logp_first is not None:
            self.metrics.set_gauge("stt.confidence_first",
                                   self._push("stt_logp_first", logp_first))
        self.metrics.set_gauge("stt.confidence_repetition",
                               self._push("stt_repetition", repetition))
        self._count("quality.stt_finals")
        self.slo.record("stt_repetition", repetition, detail)

    def record_intent(self, margin: float | None = None, entropy: float | None = None,
                      forced_frac: float | None = None, degraded: bool = False,
                      downgraded: bool = False, rule_fallback: bool = False,
                      text: str = "") -> None:
        """One parse's confidence / structural vector (brain or voice)."""
        detail = {"signal": "intent", "text": text[:60]}
        if margin is not None:
            detail["margin"] = round(margin, 4)
            self.metrics.set_gauge("quality.intent_margin", self._push("intent_margin", margin))
            self.slo.record("intent_margin", margin, detail)
        if entropy is not None:
            self.metrics.set_gauge("quality.intent_entropy",
                                   self._push("intent_entropy", entropy))
        if forced_frac is not None:
            self.metrics.set_gauge("quality.intent_forced_frac",
                                   self._push("intent_forced_frac", forced_frac))
        drate = self._push("degraded", 1.0 if (degraded or downgraded) else 0.0)
        self.metrics.set_gauge("quality.degraded_rate", drate)
        self._count("quality.parses")
        if degraded:
            self._count("quality.degraded_parses")
        if rule_fallback:
            self._count("quality.rule_fallbacks")

    def record_golden(self, type_match: bool, args_score: float, text: str = "") -> None:
        """One golden-replay canary case scored against the live parser."""
        score = (0.5 if type_match else 0.0) + 0.5 * float(args_score)
        self.metrics.set_gauge("quality.golden_accuracy", self._push("golden", score))
        trate = self._push("golden_type", 1.0 if type_match else 0.0)
        self.metrics.set_gauge("quality.golden_type_accuracy", trate)
        self.slo.record("golden_accuracy", score,
                        {"signal": "golden", "text": text[:60], "type_match": type_match,
                         "args_score": round(float(args_score), 4)})

    def state(self) -> dict:
        """The ``GET /debug/quality`` body."""
        with self._lock:
            windows = {sig: {"n": len(dq), "mean": round(sum(dq) / len(dq), 4)}
                       for sig, dq in self._win.items() if dq}
            counts = dict(self._counts)
        # exec_by_type: JAX's key, filled by record_exec (not ported)
        return {"service": self.service, "lanes_enabled": quality_lanes_enabled(),
                "windows": windows, "exec_by_type": {}, "counts": counts,
                "slo": self.slo.evaluate()}

    def health(self) -> dict:
        """The compact block ``/health`` carries."""
        means = {}
        with self._lock:
            for sig in ("golden", "intent_margin", "stt_logp_mean", "stt_repetition",
                        "exec_ok", "degraded"):
                dq = self._win.get(sig)
                if dq:
                    means[sig] = round(sum(dq) / len(dq), 4)
        out = {"slo": self.slo.state()}
        out.update(means)
        return out

    def response(self):
        """``GET /debug/quality`` as a ``services.ws.Response``."""
        from ..services.ws import Response

        return Response(200, self.state())


class GoldenCanary:
    """Per-replica golden-replay canary: a daemon loop replaying a rotating
    slice of the held-out golden cases through the live parser in idle
    cycles. ``busy_fn()`` is asked before every round and a busy replica's
    round is skipped (``quality.canary_skipped_busy``): the canary never
    takes decode steps from traffic. The rotation advances one case per
    case scored, so two replicas at the same round count scored the same
    slice."""

    def __init__(self, parse_fn, monitor: QualityMonitor, *, interval_s: float | None = None,
                 slice_n: int | None = None, busy_fn=None, cases=None):
        from ..evals.golden import GOLDEN_INTENT_CASES

        self.parse_fn = parse_fn  # (text, context) -> the ParseResponse dict
        self.monitor = monitor
        self.interval_s = interval_s if interval_s is not None \
            else _knob_float("QUALITY_CANARY_S", "0")
        self.slice_n = slice_n if slice_n is not None \
            else int(os.environ.get("QUALITY_CANARY_SLICE", "3"))
        self.busy_fn = busy_fn
        self.cases = list(cases if cases is not None else GOLDEN_INTENT_CASES)
        self._idx = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.rounds = 0

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0 and bool(self.cases)

    def run_once(self) -> int:
        """One round: score the next ``slice_n`` cases unless the replica is
        busy. Returns the cases scored."""
        from ..evals.golden import score_case

        if self.busy_fn is not None and self.busy_fn():
            self.monitor._count("quality.canary_skipped_busy")
            return 0
        scored = 0
        for _ in range(self.slice_n):
            case = self.cases[self._idx % len(self.cases)]
            self._idx += 1
            try:
                tm, ascore = score_case(case, self.parse_fn(case.text, dict(case.context)))
            except Exception:
                # a parser error on a golden input is a quality miss, not a
                # canary crash
                tm, ascore = False, 0.0
                self.monitor._count("quality.canary_errors")
            self.monitor.record_golden(tm, ascore, text=case.text)
            scored += 1
        self.rounds += 1
        self.monitor._count("quality.canary_runs")
        return scored

    def start(self) -> None:
        if not self.enabled or (self._thread is not None and self._thread.is_alive()):
            return
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 - the canary never kills the replica
                    pass

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name=f"quality-canary-{self.monitor.service}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None


def conf_fold(acc, new):
    """Fold one chunk / step's host-side conf lanes into an accumulator: THE
    one spelling of the (margin_sum, margin_min, entropy_sum, forced,
    decisions) merge rule (sums add, mins min, counts add). ``acc=None``
    starts a fresh accumulator."""
    import numpy as np

    new = [np.asarray(x) for x in new]
    if acc is None:
        return new
    return [acc[0] + new[0], np.minimum(acc[1], new[1]), acc[2] + new[2],
            acc[3] + new[3], acc[4] + new[4]]


def conf_summary(conf_h, steps: int) -> dict | None:
    """One request's lanes ``(margin_sum, margin_min, entropy_sum, forced,
    decisions)`` -> the quality dict ``GenerationResult`` carries. None when
    the lanes were off or the request made no decision."""
    margin_sum, margin_min, ent_sum, forced, cnt = conf_h
    cnt = int(cnt)
    if cnt <= 0:
        return None
    mmin = float(margin_min)
    return {
        "margin_mean": round(float(margin_sum) / cnt, 4),
        "margin_min": round(mmin, 4) if mmin != float("inf") else None,
        "entropy_mean": round(float(ent_sum) / cnt, 4),
        "forced_frac": round(float(forced) / max(1, steps), 4),
        "decisions": cnt,
    }
