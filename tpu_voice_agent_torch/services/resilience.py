"""Deadlines, retries and circuit breakers, as the JAX package's services carry them.

Port of ``tpu_voice_agent/utils/resilience.py`` with JAX's
``resilience.<dep>.*`` series (the breaker's state gauge, registered at 0 from
construction; its transition and rejection counters; the retry and
transport-error counters).

- ``Deadline``: a request's remaining time budget. The remaining
  milliseconds travel in the ``x-deadline-ms`` header, and a service answers
  a budget that has run out with 503 ``{"error": "overloaded", "detail":
  "deadline_expired"}`` and ``Retry-After: 0`` before doing any work (the
  brain's ``/parse`` gate). Inside the brain the deadline rides a
  ``RequestContext`` into the scheduler: shed at dequeue, cancelled between
  decode chunks.
- ``RequestContext``: the per-request containment handle (the deadline, and
  the cancel callbacks a client disconnect fires), installed on the thread
  that runs the parse (``push_request_context``).
- ``RetryPolicy``: jittered exponential backoff, clipped to the deadline.
- ``CircuitBreaker``: closed -> open after ``failure_threshold`` consecutive
  failures -> half-open after ``reset_after_s`` (one probe call passes). An
  opening freezes the flight recorder (``breaker.<name>.open``).
- ``AdmissionController``: the in-flight cap behind the brain's
  ``BRAIN_MAX_INFLIGHT`` (``resilience.<name>.inflight`` /
  ``max_inflight`` gauges, ``shed_overload`` counter).
- ``post_with_resilience``: the budgeted, breaker-guarded POST of the voice
  service's two hops, over ``ws.HTTPClient``.

Everything takes an injectable ``clock`` / ``rng`` / ``sleep``, so tests
drive the state machines deterministically.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from dataclasses import dataclass

from ..utils.tracing import get_flight_recorder, get_metrics
from .ws import ConnectError, HTTPError

# remaining-budget propagation header: milliseconds left, clamped at 0
DEADLINE_HEADER = "x-deadline-ms"


class ResilienceError(Exception):
    """Base for the kit's own failures (callers can catch the family)."""


class DeadlineExpired(ResilienceError):
    """The request's time budget ran out before a usable response."""


class BreakerOpenError(ResilienceError):
    """The dependency's circuit is open; the call was not attempted."""

    def __init__(self, name: str):
        super().__init__(f"circuit for {name!r} is open")
        self.name = name


class Deadline:
    """Absolute expiry on a monotonic clock, carried across hops as a
    remaining-milliseconds header (absolute wall times don't survive clock
    skew between hosts; remaining budgets do)."""

    __slots__ = ("_expires_at", "_clock")

    def __init__(self, budget_s: float, clock=time.monotonic):
        self._clock = clock
        self._expires_at = clock() + max(0.0, budget_s)

    @classmethod
    def after(cls, budget_s: float, clock=time.monotonic) -> "Deadline":
        return cls(budget_s, clock=clock)

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

    def remaining_s(self) -> float:
        return max(0.0, self._expires_at - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self._expires_at

    def header_value(self) -> str:
        return str(int(self.remaining_s() * 1e3))


class RequestContext:
    """Per-request containment handle from a service handler into the
    inference plane: the propagated ``Deadline`` and the cancel callbacks a
    client disconnect fires. ``cancel()`` is idempotent and thread-safe; a
    callback registered after cancellation fires at once. ``peer_gone``
    (optional, no arguments) is the transport's probe of its client: the
    stdlib HTTP server cannot cancel a handler, so the waiting parse asks
    ``client_gone`` between short waits."""

    def __init__(self, deadline: "Deadline | None" = None, peer_gone=None):
        self.deadline = deadline
        self._peer_gone = peer_gone
        self._lock = threading.Lock()
        self._cancelled = False
        self._cbs: list = []

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def client_gone(self) -> bool:
        return self._peer_gone is not None and bool(self._peer_gone())

    def on_cancel(self, cb) -> None:
        with self._lock:
            if not self._cancelled:
                self._cbs.append(cb)
                return
        cb()  # already cancelled: fire now, outside the lock

    def cancel(self) -> None:
        with self._lock:
            if self._cancelled:
                return
            self._cancelled = True
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception:
                get_metrics().inc("resilience.cancel_callback_errors")


_req_ctx = threading.local()


def push_request_context(ctx: RequestContext | None) -> None:
    """Install the context on THIS thread (the thread that runs the parse);
    backends read it with ``current_request_context``."""
    _req_ctx.ctx = ctx


def pop_request_context() -> None:
    _req_ctx.ctx = None


def current_request_context() -> RequestContext | None:
    return getattr(_req_ctx, "ctx", None)


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff: delay_n = base * mult^n, capped, with
    ``jitter`` fraction of the delay re-rolled uniformly so synchronized
    clients don't retry in lockstep."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.5

    def backoff_s(self, attempt: int, rng=random.random) -> float:
        delay = min(self.max_delay_s, self.base_delay_s * self.multiplier ** attempt)
        if self.jitter <= 0:
            return delay
        return delay * (1.0 - self.jitter) + delay * self.jitter * rng()


class CircuitBreaker:
    """Per-dependency circuit: ``closed`` -> ``open`` after
    ``failure_threshold`` consecutive failures (calls fail fast, no socket
    touch) -> ``half_open`` after ``reset_after_s`` (one trial call passes;
    success closes, failure re-opens). Thread-safe."""

    def __init__(self, name: str, failure_threshold: int = 3, reset_after_s: float = 2.0,
                 clock=time.monotonic):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probe_at = 0.0  # when the last half-open probe was admitted
        # the state gauge exists from construction (0 = closed): a scraper
        # sees every breaker, tripped or not
        self._gauge(0)

    @property
    def state(self) -> str:
        """Advisory (a health label); ``allow()`` is the authoritative gate."""
        with self._lock:
            if self._state == "open" and self._clock() - self._opened_at >= self.reset_after_s:
                return "half_open"  # the next allow() admits a probe
            return self._state

    def allow(self) -> bool:
        """Admission check for ONE call attempt; open -> half_open once the
        reset window has elapsed."""
        with self._lock:
            now = self._clock()
            if self._state == "closed":
                return True
            if self._state == "open":
                if now - self._opened_at < self.reset_after_s:
                    get_metrics().inc(f"resilience.{self.name}.breaker_rejected")
                    return False
                self._state = "half_open"
                get_metrics().inc(f"resilience.{self.name}.breaker_half_open")
                self._gauge(1)
            elif now - self._probe_at < self.reset_after_s:
                # the probe is out. One a reset window: an abandoned probe
                # (its caller was cancelled) must not wedge half_open forever
                get_metrics().inc(f"resilience.{self.name}.breaker_rejected")
                return False
            self._probe_at = now
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state != "closed":
                get_metrics().inc(f"resilience.{self.name}.breaker_closed")
            self._state = "closed"
            self._failures = 0
            self._gauge(0)

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            # past the reset window the breaker IS half-open, whichever label
            # is stored: a failure then re-opens it (refreshing _opened_at)
            half_open = (self._state == "half_open"
                         or (self._state == "open"
                             and self._clock() - self._opened_at >= self.reset_after_s))
            if half_open:
                self._trip()
                tripped = True
            else:
                self._failures += 1
                if self._state == "closed" and self._failures >= self.failure_threshold:
                    self._trip()
                    tripped = True
        if tripped:
            # an opening is an incident: freeze the flight recorder, outside
            # the breaker lock (the freeze copies rings and may write a file)
            get_flight_recorder().trigger(f"breaker.{self.name}.open")

    def _trip(self) -> None:
        self._state = "open"
        self._failures = 0
        self._opened_at = self._clock()
        get_metrics().inc(f"resilience.{self.name}.breaker_opened")
        self._gauge(2)

    def _gauge(self, v: int) -> None:
        get_metrics().set_gauge(f"resilience.{self.name}.breaker_state", v)


class AdmissionController:
    """In-flight cap: past ``max_inflight`` a server answers 503 +
    ``Retry-After`` instead of queueing without bound."""

    def __init__(self, name: str, max_inflight: int, retry_after_s: float = 1.0):
        self.name = name
        self.max_inflight = max(1, max_inflight)
        self.retry_after_s = retry_after_s
        self._lock = threading.Lock()
        self._inflight = 0
        # scrape-visible from construction, like the breaker state gauge
        get_metrics().set_gauge(f"resilience.{name}.inflight", 0)
        get_metrics().set_gauge(f"resilience.{name}.max_inflight", self.max_inflight)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def try_acquire(self) -> bool:
        with self._lock:
            if self._inflight >= self.max_inflight:
                get_metrics().inc(f"resilience.{self.name}.shed_overload")
                return False
            self._inflight += 1
            get_metrics().set_gauge(f"resilience.{self.name}.inflight", self._inflight)
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            get_metrics().set_gauge(f"resilience.{self.name}.inflight", self._inflight)


async def post_with_resilience(http, url: str, *, json_body, deadline: Deadline,
                               headers=None, policy: RetryPolicy | None = None,
                               breaker: CircuitBreaker | None = None,
                               sleep=None, rng=random.random):
    """One budgeted, breaker-guarded, retrying POST over ``http``
    (``ws.HTTPClient`` or anything with its ``post``).

    Retries only what is safe or invited: ``ConnectError`` (the request
    never reached the server) and 503 (the server refused before doing
    work; its ``Retry-After`` is a backoff floor, capped at half the
    remaining deadline). A failure after the request was
    sent (``ReadError``) is not retried: the server may have acted on it,
    and neither hop (/parse session turns, /execute browser actions) is
    idempotent. Each attempt is bounded by the remaining budget and carries
    it in ``x-deadline-ms``. A 5xx counts against the breaker, any other
    status for it.

    Returns the final response (a final 503 included). Raises
    ``BreakerOpenError`` without touching the socket when the circuit is
    open, ``DeadlineExpired`` when the budget ran out, or the last transport
    error."""
    policy = policy or RetryPolicy()
    sleep = sleep or asyncio.sleep
    name = breaker.name if breaker is not None else "call"
    last_exc: Exception | None = None
    resp = None
    attempts = max(1, policy.max_attempts)
    for attempt in range(attempts):
        if deadline.expired:
            break
        if breaker is not None and not breaker.allow():
            raise BreakerOpenError(name)
        hdrs = dict(headers or {})
        hdrs[DEADLINE_HEADER] = deadline.header_value()
        retry_after_s = 0.0
        try:
            resp = await asyncio.wait_for(
                http.post(url, json=json_body, headers=hdrs, timeout=deadline.remaining_s()),
                timeout=deadline.remaining_s())
            last_exc = None
        except asyncio.TimeoutError:
            if breaker is not None:
                breaker.record_failure()
            get_metrics().inc(f"resilience.{name}.transport_errors")
            last_exc, resp = DeadlineExpired(
                f"{name}: attempt exceeded the remaining budget"), None
            break  # the budget is gone; a retry cannot fit
        except ConnectError as e:
            last_exc, resp = e, None
            if breaker is not None:
                breaker.record_failure()
            get_metrics().inc(f"resilience.{name}.transport_errors")
        except HTTPError:
            if breaker is not None:
                breaker.record_failure()
            get_metrics().inc(f"resilience.{name}.transport_errors")
            raise
        else:
            if resp.status_code != 503:
                if breaker is not None:
                    if resp.status_code >= 500:
                        breaker.record_failure()
                    else:
                        breaker.record_success()
                return resp
            if breaker is not None:
                breaker.record_failure()
            try:
                retry_after_s = float(resp.headers.get("Retry-After", 0))
            except (TypeError, ValueError):
                retry_after_s = 0.0
        if attempt + 1 >= attempts:
            break
        delay = policy.backoff_s(attempt, rng)
        if retry_after_s > 0:
            delay = max(delay, min(retry_after_s, deadline.remaining_s() * 0.5))
        if deadline.remaining_s() <= delay:
            break  # the budget can't cover the wait, let alone the attempt
        get_metrics().inc(f"resilience.{name}.retries")
        await sleep(delay)
    if resp is not None:
        return resp
    if last_exc is not None:
        raise last_exc
    raise DeadlineExpired(f"{name}: deadline expired before any attempt")
