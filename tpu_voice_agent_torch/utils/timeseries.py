"""Per-service time-series rings: the fleet telemetry plane's first layer.

Port of ``tpu_voice_agent/utils/timeseries.py``. Each service keeps a
bounded in-process ring of periodic samples taken from its metrics
registries (always on, cheap to feed, copies on read):

- **gauges**: a dict copy per sample (``TS_GAUGES`` narrows them to a
  comma-separated list of name prefixes);
- **counters as rates**: per-second deltas against the previous sample;
- **histograms as window means**: each latency histogram's cumulative
  ``(sum, count)`` differenced into ``{ms_per, per_s}`` (mean ms an event
  and events a second over the window), with no percentile sort on the
  sample thread.

Served as ``GET /debug/timeseries?since=SEQ`` on the brain, the voice
service and the router: only samples with ``seq >= since`` come back, and
the body's ``next_seq`` is the cursor for the next poll. The router's fleet
scrape and the autopilot's load forecast read this surface.

Each service's ring samples the process-global registry and then its
tracer-local one; the tracer-local one wins a name both hold. In one process
holding several brains (the tests, ``chip_smoke.py``'s fleet phase) the
global registry is shared, and the tracer-local ``brain.parse`` histogram is
what keeps one replica's ``parse_ms`` apart from its peers'.

Knobs: ``TS_INTERVAL_S`` (0.5) sample cadence, ``TS_SAMPLES`` (240) ring
size, ``TS_GAUGES`` (unset = all) gauge-prefix filter.
"""

from __future__ import annotations

import os
import threading
import time
from urllib.parse import parse_qs

from .tracing import Metrics, get_metrics

TIMESERIES_ROUTE = "/debug/timeseries"


class TimeSeriesRing:
    """Bounded ring of periodic metric samples with rate derivation.

    ``sources`` are sampled in order, later registries winning name
    collisions; by default the process-global registry alone.
    ``sample_once`` is the deterministic surface tests drive (pass
    ``now_s``); ``start`` / ``stop`` run it on a daemon thread every
    ``interval_s``."""

    def __init__(self, service: str, sources: tuple[Metrics, ...] | None = None,
                 interval_s: float | None = None, max_samples: int | None = None,
                 gauge_prefixes: tuple[str, ...] | None = None, clock=time.time):
        env = os.environ.get
        self.service = service
        self.sources: tuple[Metrics, ...] = sources or (get_metrics(),)
        self.interval_s = interval_s if interval_s is not None \
            else float(env("TS_INTERVAL_S", "0.5"))
        self.max_samples = max_samples if max_samples is not None \
            else int(env("TS_SAMPLES", "240"))
        if gauge_prefixes is None:
            spec = env("TS_GAUGES") or ""
            gauge_prefixes = tuple(p.strip() for p in spec.split(",") if p.strip()) or None
        self.gauge_prefixes = gauge_prefixes
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: list[dict] = []
        self._seq = 0
        # rate baselines: the previous sample's cumulative state and time
        self._prev_t: float | None = None
        self._prev_counters: dict[str, float] = {}
        self._prev_hist: dict[str, tuple[float, int]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _merged_state(self) -> tuple[dict, dict, dict]:
        """(gauges, counters, hist) merged across sources, later wins."""
        gauges: dict[str, float] = {}
        counters: dict[str, float] = {}
        hist: dict[str, tuple[float, int]] = {}
        for src in self.sources:
            gauges.update(src.gauges())
            c, h = src.counter_state()
            counters.update(c)
            hist.update(h)
        if self.gauge_prefixes is not None:
            gauges = {k: v for k, v in gauges.items() if k.startswith(self.gauge_prefixes)}
        return gauges, counters, hist

    def sample_once(self, now_s: float | None = None) -> dict:
        """One sample: gauge copies plus counter and histogram deltas
        against the previous sample, appended to the ring and returned."""
        now = self._clock() if now_s is None else now_s
        gauges, counters, hist = self._merged_state()
        with self._lock:
            dt = (now - self._prev_t) if self._prev_t is not None else 0.0
            rates: dict[str, float] = {}
            hist_rates: dict[str, dict] = {}
            if dt > 0:
                for k, v in counters.items():
                    # a restarted registry can step a counter backwards: the
                    # window then reads 0, never a negative rate
                    delta = v - self._prev_counters.get(k, 0.0)
                    rates[k] = round(max(0.0, delta) / dt, 6)
                for k, (s, c) in hist.items():
                    ps, pc = self._prev_hist.get(k, (0.0, 0))
                    dc = c - pc
                    if dc > 0 and s >= ps:
                        hist_rates[k] = {"ms_per": round((s - ps) / dc, 3),
                                         "per_s": round(dc / dt, 6)}
            self._prev_t = now
            self._prev_counters = counters
            self._prev_hist = hist
            sample = {"seq": self._seq, "t_s": round(now, 3), "dt_s": round(dt, 3),
                      "gauges": gauges, "rates": rates, "hist": hist_rates}
            self._seq += 1
            self._samples.append(sample)
            if len(self._samples) > self.max_samples:
                del self._samples[: len(self._samples) - self.max_samples]
            buffered = len(self._samples)
        get_metrics().set_gauge("ts.samples_buffered", float(buffered))
        return sample

    def since(self, seq: int) -> list[dict]:
        """Samples with ``seq >= seq``. Seqs are monotonic and never
        reused, so a cursor survives trimming."""
        with self._lock:
            return [dict(s) for s in self._samples if s["seq"] >= seq]

    def state(self, since: int = 0) -> dict:
        """The ``/debug/timeseries`` body. ``now_s`` lets a scraper estimate
        this process's wall-clock skew (server now against the request's
        local midpoint)."""
        with self._lock:
            samples = [dict(s) for s in self._samples if s["seq"] >= since]
            next_seq = self._seq
        return {"service": self.service, "interval_s": self.interval_s,
                "max_samples": self.max_samples, "now_s": round(time.time(), 6),
                "next_seq": next_seq, "samples": samples}

    def start(self) -> None:
        """Start the sampler thread (idempotent); the first sample fires at
        once to set the rate baseline."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self.sample_once()

        def run() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:  # noqa: BLE001 - telemetry never kills the service
                    pass

        self._thread = threading.Thread(target=run, daemon=True, name=f"ts-{self.service}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None


def service_ring(service: str, tracer=None) -> TimeSeriesRing:
    """A service's ring: the global registry, then the tracer-local one."""
    sources = (get_metrics(),) + ((tracer.metrics,) if tracer is not None else ())
    return TimeSeriesRing(service, sources=sources)


def timeseries_response(ring: TimeSeriesRing, request):
    """``GET /debug/timeseries`` (a ``services.ws.Request`` in, a
    ``Response`` out): the ring as JSON; ``?since=SEQ`` returns only samples
    with seq >= SEQ."""
    from ..services.ws import Response

    try:
        since = int(parse_qs(request.query or "").get("since", ["0"])[0])
    except ValueError:
        since = 0
    return Response(200, ring.state(since=since))
