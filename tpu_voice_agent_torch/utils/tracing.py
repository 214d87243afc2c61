"""Per-stage tracing, the metrics registry and its Prometheus exposition.

Port of ``tpu_voice_agent/utils/tracing.py``, with JAX's names:

- ``Metrics``: process-local counters, gauges and latency histograms
  (a bounded reservoir for exact recent percentiles in the JSON snapshot,
  fixed log-spaced buckets for the Prometheus histogram), lock-protected,
  each name's kind recorded so ``collisions()`` flags one name registered
  as two kinds. ``get_metrics()`` is the process-global registry the
  serving runtime (engine, scheduler, STT, spec decoder) records into.
- ``Tracer``: spans into its own ``Metrics`` (``<service>.<span>``
  histograms), a bounded ring keyed by trace id (``GET
  /debug/trace/{trace_id}``), and the ``TRACE_SINK=<path>`` JSONL sink.
- Stage notes: a thread-local side channel through which a parser hands
  its decode split (prefill / decode ms, cached tokens, the intent
  confidence) to the handler that called it on the same thread.
- The ``/metrics`` and ``/debug/trace/{trace_id}`` handlers, on the port's
  ``services/ws.py`` ``Request`` / ``Response``: ``/metrics`` answers JSON
  by default and Prometheus text (version 0.0.4) when the ``Accept`` header
  asks for ``text/plain`` or ``openmetrics``.

- ``FlightRecorder``: a bounded always-on ring of the last
  ``FLIGHT_TRACES`` traces (every finished span of every ``Tracer`` feeds
  it) and ``FLIGHT_SNAPSHOTS`` gauge snapshots (one per
  ``FLIGHT_SNAPSHOT_S`` on the span stream), frozen into one dump, with the
  step ledger's ring, at the first incident: an SLO's ok -> violated edge,
  a breaker opening, the scheduler's quarantine. ``FLIGHT_SINK=<prefix>``
  also writes the dump as JSON, on the triggering thread. ``GET
  /debug/flightrecorder`` (``flightrecorder_response``) answers it, and
  ``?rearm=1`` re-arms after answering.

``counter_state`` feeds only the time-series ring (ROADMAP.md Queue 1 item
7). A freeze's ``costs`` is None: the port has no cost meter (item 4).
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from urllib.parse import parse_qs


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def log_event(service: str, event: str, trace_id: str | None = None, **fields) -> None:
    """One structured log line to stderr: ``{"svc", "event", "trace"?, ...}``."""
    payload: dict = {"svc": service, "event": event}
    if trace_id:
        payload["trace"] = trace_id
    payload.update({k: v for k, v in fields.items()
                    if isinstance(v, (str, int, float, bool)) or v is None})
    print(json.dumps(payload), file=sys.stderr, flush=True)


@dataclass
class Span:
    name: str
    trace_id: str
    start_s: float
    end_s: float = 0.0
    wall_start_s: float = 0.0  # epoch seconds; comparable across processes
    attrs: dict = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return (self.end_s - self.start_s) * 1e3


# span names become metric keys (f"{service}.{name}"): per-request values in
# the name would explode the registry, so attr-ish syntax is refused
_BAD_SPAN_NAME = re.compile(r"[{}=\s]")


def _check_span_name(name: str) -> str:
    if not name or _BAD_SPAN_NAME.search(name):
        raise ValueError(
            f"bad span name {name!r}: span names are metric keys and must "
            "not contain '{', '}', '=' or whitespace — put per-request "
            "values in attrs, not the name")
    return name


def nearest_rank(sorted_xs, q: float):
    """Nearest-rank percentile on the interpolation index ``q * (n - 1)``,
    half-up: 1 sample -> that sample for every q; 2 samples -> the lower for
    q < 0.5, the upper from q >= 0.5."""
    n = len(sorted_xs)
    if n == 0:
        raise ValueError("no samples")
    idx = int(q * (n - 1) + 0.5)
    return sorted_xs[min(n - 1, max(0, idx))]


# fixed log-spaced millisecond bucket bounds (1-2-5 per decade)
HIST_BUCKETS_MS: tuple[float, ...] = (
    1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000,
)


class Metrics:
    """Process-local counters + gauges + latency histograms (lock-protected).

    Latencies keep a bounded reservoir (exact recent percentiles for the JSON
    snapshot) and fixed cumulative buckets (the Prometheus histogram)."""

    # bounded reservoir per key: a long-lived service must not grow (or
    # sort) an unbounded sample list on every scrape
    MAX_SAMPLES = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._latencies: dict[str, list[float]] = {}
        # name -> {"buckets": per-bound counts, "sum": float, "count": int}
        self._hist: dict[str, dict] = {}
        self._kinds: dict[str, str] = {}
        self._collisions: set[tuple[str, str, str]] = set()

    def _kind(self, name: str, kind: str) -> None:
        prev = self._kinds.get(name)
        if prev is None:
            self._kinds[name] = kind
        elif prev != kind:
            self._collisions.add((name, prev, kind))

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._kind(name, "counter")
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._kind(name, "gauge")
            self._gauges[name] = float(value)

    def observe_ms(self, name: str, ms: float) -> None:
        with self._lock:
            self._kind(name, "histogram")
            xs = self._latencies.setdefault(name, [])
            xs.append(ms)
            if len(xs) > self.MAX_SAMPLES:
                del xs[: len(xs) // 2]  # amortized trim, keeps the recent half
            h = self._hist.get(name)
            if h is None:
                h = self._hist[name] = {
                    "buckets": [0] * len(HIST_BUCKETS_MS), "sum": 0.0, "count": 0,
                }
            for i, bound in enumerate(HIST_BUCKETS_MS):
                if ms <= bound:
                    h["buckets"][i] += 1
                    break
            h["sum"] += ms
            h["count"] += 1

    def gauges(self) -> dict[str, float]:
        """Gauge-only copy (one lock hold, no reservoir sorting)."""
        with self._lock:
            return dict(self._gauges)

    def collisions(self) -> list[tuple[str, str, str]]:
        """(name, first_kind, other_kind) for every name registered as two
        different metric types."""
        with self._lock:
            return sorted(self._collisions)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self._counters), "gauges": dict(self._gauges),
                   "latency_ms": {}}
            for k, xs in self._latencies.items():
                s = sorted(xs)
                out["latency_ms"][k] = {
                    "count": len(s),
                    "p50": nearest_rank(s, 0.50),
                    "p95": nearest_rank(s, 0.95),
                    "p99": nearest_rank(s, 0.99),
                    "max": s[-1],
                }
        return out

    def _prom_state(self) -> tuple[dict, dict, dict]:
        """Consistent copies for exposition (rendered outside the lock)."""
        with self._lock:
            hist = {k: {"buckets": list(v["buckets"]), "sum": v["sum"], "count": v["count"]}
                    for k, v in self._hist.items()}
            return dict(self._counters), dict(self._gauges), hist


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Dotted internal names -> valid Prometheus metric names."""
    n = _PROM_BAD.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _fmt(v: float) -> str:
    return repr(round(v, 6)) if isinstance(v, float) and v != int(v) else str(int(v))


PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def prometheus_exposition(*metrics: Metrics) -> str:
    """Render registries as Prometheus text exposition (version 0.0.4).
    Counters get the ``_total`` suffix, latency keys become ``<name>_ms``
    histograms over ``HIST_BUCKETS_MS``. On a name in two registries the
    first registry wins (a service passes its tracer-local one first)."""
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, dict] = {}
    for m in metrics:
        c, g, h = m._prom_state()
        for k, v in c.items():
            counters.setdefault(k, v)
        for k, v in g.items():
            gauges.setdefault(k, v)
        for k, v in h.items():
            hists.setdefault(k, v)

    lines: list[str] = []
    for k in sorted(counters):
        n = prom_name(k) + "_total"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(counters[k])}")
    for k in sorted(gauges):
        n = prom_name(k)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(gauges[k])}")
    for k in sorted(hists):
        n = prom_name(k) + "_ms"
        h = hists[k]
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for bound, cnt in zip(HIST_BUCKETS_MS, h["buckets"]):
            cum += cnt
            lines.append(f'{n}_bucket{{le="{_fmt(float(bound))}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{n}_sum {_fmt(h['sum'])}")
        lines.append(f"{n}_count {h['count']}")
    return "\n".join(lines) + "\n"


# Process-global registry: the serving runtime records here without a
# Metrics plumbed through every constructor; /metrics serves it next to the
# service's tracer-local registry
_GLOBAL_METRICS = Metrics()


def get_metrics() -> Metrics:
    return _GLOBAL_METRICS


class FlightRecorder:
    """The overload flight recorder: bounded rings of the last traces
    (``observe_span``, fed by every ``Tracer``) and of periodic gauge
    snapshots, frozen into an immutable dump by ``trigger``. The FIRST
    trigger wins (later ones while frozen change nothing), so the dump shows
    the onset of the incident; ``rearm`` clears it."""

    def __init__(self, max_traces: int | None = None, max_snapshots: int | None = None,
                 snapshot_interval_s: float | None = None):
        env = os.environ.get
        self.max_traces = max_traces if max_traces is not None \
            else int(env("FLIGHT_TRACES", "32"))
        self.max_snapshots = max_snapshots if max_snapshots is not None \
            else int(env("FLIGHT_SNAPSHOTS", "120"))
        self.snapshot_interval_s = snapshot_interval_s if snapshot_interval_s is not None \
            else float(env("FLIGHT_SNAPSHOT_S", "1.0"))
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, list[dict]] = OrderedDict()
        self._snapshots: list[dict] = []
        self._last_snapshot_s = 0.0
        self._frozen: dict | None = None

    def observe_span(self, span_dict: dict) -> None:
        """Deposit one finished span; a gauge snapshot rides the span stream
        once ``snapshot_interval_s`` has passed."""
        trace_id = span_dict.get("trace")
        if not trace_id:
            return
        with self._lock:
            ring = self._traces.setdefault(trace_id, [])
            if len(ring) < Tracer.MAX_SPANS_PER_TRACE:
                ring.append(span_dict)
            self._traces.move_to_end(trace_id)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
            due = (time.time() - self._last_snapshot_s) >= self.snapshot_interval_s
            if due:
                self._last_snapshot_s = time.time()
        if due:
            self.snapshot_metrics()

    def snapshot_metrics(self) -> None:
        """Append one timestamped gauge snapshot to the bounded ring."""
        entry = {"t_s": round(time.time(), 3), "gauges": get_metrics().gauges()}
        with self._lock:
            self._snapshots.append(entry)
            if len(self._snapshots) > self.max_snapshots:
                del self._snapshots[: len(self._snapshots) - self.max_snapshots]
        m = get_metrics()
        m.set_gauge("flight.traces_buffered", float(len(self._traces)))
        m.set_gauge("flight.snapshots_buffered", float(len(self._snapshots)))

    def trigger(self, reason: str, detail: str | None = None, extra: dict | None = None) -> bool:
        """Freeze the rings under ``reason``; True when this call froze.
        ``extra`` rides the dump under its own key."""
        self.snapshot_metrics()  # the knee itself belongs in the timeline
        from .steplog import get_steplog

        steplog = get_steplog().dump()  # outside the ring lock: it has its own
        with self._lock:
            if self._frozen is not None:
                return False
            self._frozen = {
                "frozen": True,
                "reason": reason,
                "detail": detail,
                "frozen_at_s": round(time.time(), 3),
                "traces": [{"trace_id": tid, "spans": list(spans)}
                           for tid, spans in self._traces.items()],
                "metric_snapshots": list(self._snapshots),
                "steplog": steplog,
                "costs": None,
                "config": {"max_traces": self.max_traces,
                           "max_snapshots": self.max_snapshots,
                           "snapshot_interval_s": self.snapshot_interval_s},
            }
            if extra:
                self._frozen["extra"] = dict(extra)
            dump = self._frozen
        get_metrics().inc("flight.freezes")
        log_event("flight", "frozen", reason=reason, detail=detail,
                  traces=len(dump["traces"]), snapshots=len(dump["metric_snapshots"]))
        sink = os.environ.get("FLIGHT_SINK")
        if sink:
            try:
                safe = re.sub(r"[^A-Za-z0-9_.-]", "_", reason)
                with open(f"{sink}_{safe}_{int(dump['frozen_at_s'])}.json", "w") as f:
                    json.dump(dump, f)
            except OSError:
                # a full disk must not take the overload path down with it
                get_metrics().inc("flight.sink_write_errors")
        return True

    def rearm(self) -> None:
        """Discard the frozen dump; the recorder is armed again."""
        with self._lock:
            self._frozen = None

    def frozen_dump(self) -> dict | None:
        with self._lock:
            return self._frozen

    def state(self, service: str | None = None) -> dict:
        """The ``/debug/flightrecorder`` body: the frozen dump, else the
        armed live counts."""
        with self._lock:
            if self._frozen is not None:
                body = dict(self._frozen)
            else:
                body = {"frozen": False, "armed": True,
                        "traces_buffered": len(self._traces),
                        "snapshots_buffered": len(self._snapshots)}
        if service is not None:
            body["service"] = service
        return body


# process-global, like the metrics registry: SLO trackers, breakers and the
# scheduler trigger it, every Tracer feeds it
_GLOBAL_FLIGHT = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _GLOBAL_FLIGHT


def flightrecorder_response(service: str, request):
    """``GET /debug/flightrecorder``: the frozen dump or the armed state;
    ``?rearm=1`` re-arms after answering."""
    from ..services.ws import Response

    rec = get_flight_recorder()
    body = rec.state(service)
    if parse_qs(request.query or "").get("rearm") == ["1"]:
        rec.rearm()
        body["rearmed"] = True
    return Response(200, body)


def metrics_response(service: str, tracer: "Tracer", request, slo=None):
    """``GET /metrics`` (a ``services.ws.Request`` in, a ``Response`` out).
    ``?gauges=1`` is the cheap poll: gauge copies only. Otherwise JSON
    (the service's tracer-local snapshot beside the process-global runtime
    one, plus the SLO evaluation when a tracker is wired), or Prometheus
    text when ``Accept`` asks for ``text/plain`` or ``openmetrics`` (the
    SLO gauges ride the global registry, refreshed by the evaluation)."""
    from ..services.ws import Response

    query = parse_qs(request.query or "")
    if query.get("gauges") == ["1"]:
        return Response(200, {"service": service,
                              "local": {"gauges": tracer.metrics.gauges()},
                              "runtime": {"gauges": get_metrics().gauges()}})
    slo_eval = slo.evaluate() if slo is not None else None
    accept = request.headers.get("accept", "") or ""
    if "text/plain" in accept or "openmetrics" in accept:
        return Response(200, prometheus_exposition(tracer.metrics, get_metrics()),
                        {"Content-Type": PROM_CONTENT_TYPE})
    body = {"service": service, "local": tracer.metrics.snapshot(),
            "runtime": get_metrics().snapshot()}
    if slo is not None:
        body["slo"] = slo_eval
    return Response(200, body)


TRACE_ROUTE = "/debug/trace/"


def trace_response(service: str, tracer: "Tracer", request):
    """``GET /debug/trace/{trace_id}``: this service's completed spans for
    one trace id, from the tracer's bounded ring."""
    from ..services.ws import Response

    trace_id = request.path[len(TRACE_ROUTE):]
    return Response(200, {"service": service, "trace_id": trace_id,
                          "spans": tracer.spans_for(trace_id)})


# Stage notes: a thread-local side channel for per-request decode stats. The
# parser knows the decode split but not the request's trace id; the handler
# knows the trace id. The parser deposits notes on the calling thread (from
# the request's own result), the handler pops them after the parse returns.
_stage_notes = threading.local()


def note_stage(key: str, value: float) -> None:
    d = getattr(_stage_notes, "d", None)
    if d is None:
        d = _stage_notes.d = {}
    d[key] = value


def pop_stage_notes() -> dict:
    d = getattr(_stage_notes, "d", None)
    _stage_notes.d = {}
    return d or {}


def peek_stage_notes() -> dict:
    """The current thread's notes, not cleared (a two-phase speculative turn
    keeps its split for the commit that replays it)."""
    return dict(getattr(_stage_notes, "d", None) or {})


class Tracer:
    """Records spans into its ``Metrics``, a bounded per-trace ring, the
    ``TRACE_SINK`` JSONL file when set, and (``emit=True``) one JSON line on
    stderr per span."""

    MAX_TRACES = 256  # distinct trace ids kept in the ring
    MAX_SPANS_PER_TRACE = 512

    def __init__(self, service: str, metrics: Metrics | None = None, emit: bool = True,
                 sink_path: str | None = None):
        self.service = service
        self.metrics = metrics or Metrics()
        self.emit = emit
        self._lock = threading.Lock()
        # LRU ring of completed spans keyed by trace id, for /debug/trace
        self._ring: OrderedDict[str, list[dict]] = OrderedDict()
        self._sink_path = (sink_path if sink_path is not None
                           else os.environ.get("TRACE_SINK") or None)
        # opened once and kept: an open + close per span would put a
        # filesystem round trip on the request path
        self._sink_file = None
        self._sink_lock = threading.Lock()

    @contextmanager
    def span(self, name: str, trace_id: str | None = None, **attrs):
        _check_span_name(name)
        sp = Span(name=name, trace_id=trace_id or new_trace_id(),
                  start_s=time.perf_counter(), wall_start_s=time.time(), attrs=attrs)
        try:
            yield sp
        finally:
            sp.end_s = time.perf_counter()
            self._finish(sp)

    def record_span(self, name: str, trace_id: str, start_s: float, end_s: float,
                    **attrs) -> Span:
        """Record a span from already-measured ``perf_counter`` bounds (a
        stage whose trace id is known only after the fact)."""
        _check_span_name(name)
        sp = Span(name=name, trace_id=trace_id, start_s=start_s, end_s=end_s,
                  wall_start_s=time.time() - max(0.0, time.perf_counter() - start_s),
                  attrs=attrs)
        self._finish(sp)
        return sp

    def spans_for(self, trace_id: str) -> list[dict]:
        with self._lock:
            return list(self._ring.get(trace_id, ()))

    def _finish(self, sp: Span) -> None:
        d = {
            "svc": self.service,
            "span": sp.name,
            "trace": sp.trace_id,
            "ms": round(sp.duration_ms, 3),
            "wall_start_s": round(sp.wall_start_s, 6),
            "wall_end_s": round(sp.wall_start_s + sp.duration_ms / 1e3, 6),
            **{k: v for k, v in sp.attrs.items() if isinstance(v, (str, int, float, bool))},
        }
        with self._lock:
            ring = self._ring.setdefault(sp.trace_id, [])
            if len(ring) < self.MAX_SPANS_PER_TRACE:
                ring.append(d)
            self._ring.move_to_end(sp.trace_id)
            while len(self._ring) > self.MAX_TRACES:
                self._ring.popitem(last=False)
        self.metrics.observe_ms(f"{self.service}.{sp.name}", sp.duration_ms)
        # every finished span lands in the flight recorder's ring too
        _GLOBAL_FLIGHT.observe_span(d)
        if self._sink_path:
            try:
                with self._sink_lock:
                    if self._sink_file is None:
                        self._sink_file = open(self._sink_path, "a")
                    self._sink_file.write(json.dumps(d) + "\n")
                    self._sink_file.flush()
            except OSError:
                # a full disk or a revoked path never takes the request down:
                # drop this write, retry with a fresh handle next span
                self.metrics.inc("tracing.sink_write_errors")
                with self._sink_lock:
                    if self._sink_file is not None:
                        try:
                            self._sink_file.close()
                        except OSError:
                            pass
                        self._sink_file = None
        if self.emit:
            print(json.dumps(d), file=sys.stderr, flush=True)
