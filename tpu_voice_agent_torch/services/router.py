"""Replicated brain tier: a session-affine router over N brain replicas.

Port of ``tpu_voice_agent/services/router.py`` on the port's own HTTP layer
(``services/ws.py``: the listener, and the client for every forward, probe
and scrape). It exposes the brain's contract (``POST /parse``, ``GET
/health``, ``GET /metrics``, ``/debug/*``, ``POST /admin/drain``) in front
of ``BRAIN_REPLICAS=url,url,...``, so the voice service points ``BRAIN_URL``
at it and a replica crash, hang or rolling restart costs a re-prefill, never
a session:

- **Affinity.** ``session_id`` -> replica by rendezvous hashing over the
  admitting members (``services/replicaset.py``, the same weights as JAX's);
  a placed session stays on its home while the home is servable, and every
  forced move counts ``router.sessions_rehomed``.
- **Health.** A prober polls each member's ``/health`` every
  ``ROUTER_PROBE_S`` (``ROUTER_PROBE_FAILS`` failures eject it; a 503 body is
  a failure); every transport failure of a forward feeds the member's
  breaker. With ``FLEET_DETECT`` on (the default) each sweep also scrapes
  the members' ``/debug/timeseries`` deltas and demotes a sustained
  peer-relative outlier to *gray*: no new sessions, its sticky ones stay.
- **Failover inside the budget.** A parse whose home fails mid-flight is
  retried once on the session's new home inside the request's
  ``x-deadline-ms`` (the first attempt takes at most half the budget when a
  retry is possible; an ejection cancels it early). Speculative parses and
  prefix feeds are never replayed: they answer 409.
- **Drain.** ``POST /admin/drain {"replica": url}`` stops placing new
  sessions there and forwards the drain; at zero in flight the member is
  ``drained`` and its sessions re-home. ``HANDOFF_ENABLE=1`` ships a
  re-homed session's warm state (``GET /admin/handoff/{id}`` -> ``POST
  /admin/handoff``; ``HANDOFF_FRAMED=1`` in ``TVAF1`` frames) before the
  forward: ``router.sessions_rehomed_warm`` / ``_cold``.
- **Hedging.** ``ROUTER_HEDGE_MS`` > 0 fires a second attempt at the
  next-best member for an idempotent parse (speculative or session-less)
  still unanswered after the delay; the first usable answer wins and the
  loser is cancelled.
- **Handler cancellation.** A caller that closes its connection cancels the
  handler (``ws.serve`` does so for every app); the forward's task is
  cancelled with it and closes its socket, and the port brain's socket probe
  then evicts the decode slot.
- **Full outage.** No member in the ring: 503 ``overloaded`` with
  ``Retry-After`` (``resilience.shed_response``).
- **Disaggregation.** ``ROUTER_DISAGG=1``: members tagged ``url#prefill``
  (or in ``ROUTER_PREFILL_REPLICAS``, or self-reporting ``BRAIN_ROLE``) form
  the prefill pool. A parse whose uncached-prompt estimate clears
  ``DISAGG_MIN_TOKENS`` first runs ``/admin/disagg/prefill`` on a prefill
  member and pumps its ``TVAF1`` frames (``DISAGG_STREAM_BLOCKS`` blocks a
  segment) into the decode home's ``/admin/disagg/adopt`` as they arrive;
  prefix feeds ride the same wire and speculative parses go to the pool.
  Every failure falls back to the plain forward, counted
  ``disagg.fallbacks``.

All ring state lives on the router's one event loop: routing, the session
table and the in-flight counts change only between awaits.

    BRAIN_REPLICAS=http://127.0.0.1:8091,http://127.0.0.1:8092 \\
        python -m tpu_voice_agent_torch.services.router

Environment (JAX's names and defaults): ``BRAIN_REPLICAS``, ``ROUTER_PORT``
(8095), ``ROUTER_PROBE_S`` (0.5), ``ROUTER_PROBE_TIMEOUT_S`` (2),
``ROUTER_PROBE_FAILS`` (2), ``ROUTER_HEDGE_MS`` (0), ``ROUTER_PARSE_TIMEOUT_S``
(60), ``ROUTER_SESSIONS`` (4096), ``ROUTER_BREAKER_THRESHOLD`` (3),
``ROUTER_BREAKER_RESET_S`` (2), ``ROUTER_SHED_PRESSURE`` (0.9),
``ROUTER_DISAGG``, ``ROUTER_PREFILL_REPLICAS``, ``DISAGG_MIN_TOKENS`` (256),
``DISAGG_STREAM_BLOCKS`` (4), ``HANDOFF_ENABLE``, ``HANDOFF_TIMEOUT_S`` (5),
``HANDOFF_FRAMED``, ``FLEET_DETECT`` (1), ``FLEET_GRAY_MAD`` (4),
``FLEET_GRAY_WINDOWS`` (3), ``FLEET_MIN_PEERS`` (3), ``FLEET_GRAY_HOLD_S``
(300), ``SLO_*``, ``TS_*``, ``TRACE_SINK``, ``FLIGHT_*``. ``main`` merges the
repo-root ``.env`` first (``utils.envcfg``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import urllib.parse
from collections import deque

from ..utils.envcfg import load_env_cascade
from ..utils.timeseries import TIMESERIES_ROUTE, service_ring, timeseries_response
from ..utils.tracing import (
    TRACE_ROUTE,
    Tracer,
    flightrecorder_response,
    get_flight_recorder,
    get_metrics,
    log_event,
    metrics_response,
    new_trace_id,
    trace_response,
)
from . import ws as wslib
from .replicaset import Replica, ReplicaSet, reduce_window
from .resilience import DEADLINE_HEADER, Deadline, shed_response
from .slo import SLOTracker

log = logging.getLogger("tpu_voice_agent_torch.router")

# response headers forwarded back to the caller verbatim
_PASS_HEADERS = ("x-trace-id", "x-prefill-ms", "x-decode-ms", "x-cached-tokens",
                 "x-prompt-tokens", "x-intent-margin", "x-speculation-pending", "retry-after")
# aiohttp's client_max_size of the JAX router: a parse body past it is 413
MAX_BODY_BYTES = 8 * 1024 * 1024
# transport failures of one exchange with a member
_TRANSPORT = (wslib.HTTPError, OSError, asyncio.TimeoutError)


class ReplicaFailed(RuntimeError):
    """One forward attempt failed at the transport level (connect error,
    reset, attempt timeout, or mid-flight ejection): retryable on the
    session's next home. Never raised for an HTTP answer."""


class BrainRouter(ReplicaSet):
    """Routing state and forwarding; ``build_app`` wires it to HTTP. The
    ring state machine is ``services.replicaset.ReplicaSet``; this class
    owns probing, forwarding, hedging, failover, the warm handoff and the
    disagg orchestration."""

    def __init__(self, replica_urls: list[str], *, probe_s: float | None = None,
                 probe_timeout_s: float | None = None, probe_fails: int | None = None,
                 hedge_ms: float | None = None, parse_timeout_s: float | None = None,
                 max_sessions: int | None = None, breaker_threshold: int | None = None,
                 breaker_reset_s: float | None = None, handoff_enable: bool | None = None,
                 handoff_timeout_s: float | None = None, shed_pressure: float | None = None,
                 fleet_detect: bool | None = None, fleet_mad: float | None = None,
                 fleet_windows: int | None = None, fleet_min_peers: int | None = None,
                 fleet_hold_s: float | None = None, disagg: bool | None = None,
                 disagg_min_tokens: int | None = None, disagg_stream_blocks: int | None = None,
                 prefill_urls: list[str] | None = None):
        if not replica_urls:
            raise ValueError("BRAIN_REPLICAS must name at least one replica")
        env = os.environ.get
        # ``url#role`` tags in the list and ROUTER_PREFILL_REPLICAS build the
        # disagg pools; the ring's keys stay bare urls
        roles: dict[str, str] = {}
        keys: list[str] = []
        for u in replica_urls:
            base, _, tag = str(u).strip().partition("#")
            base = base.rstrip("/")
            if not base:
                continue
            keys.append(base)
            if tag in ("prefill", "decode", "both"):
                roles[base] = tag
        if prefill_urls is None:
            prefill_urls = [u.strip() for u in env("ROUTER_PREFILL_REPLICAS", "").split(",")
                            if u.strip()]
        for u in prefill_urls:
            base = str(u).partition("#")[0].rstrip("/")
            if not base:
                continue
            if base not in keys:
                keys.append(base)
            roles[base] = "prefill"
        self.disagg = disagg if disagg is not None else env("ROUTER_DISAGG") == "1"
        self.disagg_min_tokens = disagg_min_tokens if disagg_min_tokens is not None \
            else int(env("DISAGG_MIN_TOKENS", "256"))
        self.disagg_stream_blocks = disagg_stream_blocks if disagg_stream_blocks is not None \
            else int(env("DISAGG_STREAM_BLOCKS", "4"))
        self.handoff_framed = env("HANDOFF_FRAMED", "0") == "1"
        if fleet_detect is None:
            fleet_detect = env("FLEET_DETECT", "1") != "0"
        fleet_mad = fleet_mad if fleet_mad is not None else float(env("FLEET_GRAY_MAD", "4.0"))
        self.probe_s = probe_s if probe_s is not None else float(env("ROUTER_PROBE_S", "0.5"))
        self.probe_timeout_s = probe_timeout_s if probe_timeout_s is not None \
            else float(env("ROUTER_PROBE_TIMEOUT_S", "2.0"))
        self.hedge_ms = hedge_ms if hedge_ms is not None else float(env("ROUTER_HEDGE_MS", "0"))
        self.parse_timeout_s = parse_timeout_s if parse_timeout_s is not None \
            else float(env("ROUTER_PARSE_TIMEOUT_S", "60"))
        self.handoff_enable = handoff_enable if handoff_enable is not None \
            else env("HANDOFF_ENABLE") == "1"
        self.handoff_timeout_s = handoff_timeout_s if handoff_timeout_s is not None \
            else float(env("HANDOFF_TIMEOUT_S", "5.0"))
        super().__init__(
            keys,
            probe_fails_limit=(probe_fails if probe_fails is not None
                               else int(env("ROUTER_PROBE_FAILS", "2"))),
            breaker_threshold=(breaker_threshold if breaker_threshold is not None
                               else int(env("ROUTER_BREAKER_THRESHOLD", "3"))),
            breaker_reset_s=(breaker_reset_s if breaker_reset_s is not None
                             else float(env("ROUTER_BREAKER_RESET_S", "2.0"))),
            max_sessions=(max_sessions if max_sessions is not None
                          else int(env("ROUTER_SESSIONS", "4096"))),
            shed_pressure=(shed_pressure if shed_pressure is not None
                           else float(env("ROUTER_SHED_PRESSURE", "0.9"))),
            gray_mad=(fleet_mad if fleet_detect else None),
            gray_windows=(fleet_windows if fleet_windows is not None
                          else int(env("FLEET_GRAY_WINDOWS", "3"))),
            gray_min_peers=(fleet_min_peers if fleet_min_peers is not None
                            else int(env("FLEET_MIN_PEERS", "3"))),
            gray_hold_s=(fleet_hold_s if fleet_hold_s is not None
                         else float(env("FLEET_GRAY_HOLD_S", "300"))),
            log_name="tpu_voice_agent_torch.router")
        for base, role in roles.items():
            member = self._by_url.get(base)
            if member is not None:
                member.role = role
        if self.disagg:
            # general placement avoids the prefill pool (the whole ring
            # serves if that would empty it)
            self.exclude_roles = {"prefill"}
        # disagg state: per-session (home, prompt, cached) tokens from the
        # response headers, a rolling (t, blocks) window for /health, and
        # the live export count behind the prefill-queue gauge
        self._session_tokens: dict[str, tuple[str, int, int]] = {}
        self._stream_win: deque[tuple[float, int]] = deque()
        self._disagg_inflight = 0
        self._http: wslib.HTTPClient | None = None
        self._probe_task: asyncio.Task | None = None
        self.autopilot = None  # an AutopilotController registers itself here
        # the contract series exist from construction (scrape-visible at 0)
        m = get_metrics()
        m.inc("router.sessions_rehomed", 0.0)
        m.inc("router.sessions_rehomed_warm", 0.0)
        m.inc("router.sessions_rehomed_cold", 0.0)
        m.inc("router.shed_pressure", 0.0)
        m.inc("router.hedges_fired", 0.0)
        m.inc("router.hedges_won", 0.0)
        m.inc("router.drains", 0.0)
        m.inc("router.retries", 0.0)
        m.inc("router.spec_discarded", 0.0)
        m.inc("fleet.scrapes", 0.0)
        m.inc("fleet.gray_entered", 0.0)
        m.inc("fleet.gray_recovered", 0.0)
        m.inc("fleet.shed_gray", 0.0)
        m.inc("router.replicas_added", 0.0)
        m.inc("router.replicas_removed", 0.0)
        m.inc("disagg.admissions", 0.0)
        m.inc("disagg.fallbacks", 0.0)
        m.inc("disagg.feeds_routed", 0.0)
        m.inc("disagg.spec_routed", 0.0)
        m.inc("disagg.frames_streamed", 0.0)
        m.inc("disagg.tokens_prewarmed", 0.0)
        m.set_gauge("fleet.gray_replicas", 0.0)
        m.set_gauge("fleet.outlier_score_max", 0.0)
        m.set_gauge("disagg.prefill_replicas", 0.0)
        m.set_gauge("disagg.decode_replicas", 0.0)
        m.set_gauge("disagg.prefill_queue", 0.0)
        self._update_health_gauge()

    # ---------------------------------------------- replica-set hooks

    def _update_health_gauge(self) -> None:
        m = get_metrics()
        m.set_gauge("router.replicas_total", float(len(self.replicas)))
        m.set_gauge("router.replicas_healthy", sum(1 for r in self.replicas if r.servable()))

    def _on_member_added(self, replica: Replica) -> None:
        get_metrics().inc("router.replicas_added")

    def _on_member_removed(self, replica: Replica) -> None:
        get_metrics().inc("router.replicas_removed")
        # a retired member's outlier gauge must not linger as if it reported
        get_metrics().set_gauge(f"fleet.outlier.{replica.idx}", 0.0)

    def _on_rehome(self) -> None:
        get_metrics().inc("router.sessions_rehomed")

    def _on_shed_pressure(self) -> None:
        get_metrics().inc("router.shed_pressure")

    def _on_drain(self) -> None:
        get_metrics().inc("router.drains")

    def _on_drain_completed(self) -> None:
        get_metrics().inc("router.drains_completed")

    def _on_ejected(self, replica: Replica) -> None:
        get_metrics().inc("router.replicas_ejected")

    def _on_recovered(self, replica: Replica) -> None:
        get_metrics().inc("router.replicas_recovered")

    def _on_shed_gray(self) -> None:
        get_metrics().inc("fleet.shed_gray")

    def _on_gray_entered(self, replica: Replica, evidence: dict) -> None:
        get_metrics().inc("fleet.gray_entered")
        log_event("router", "replica_gray", replica=replica.url,
                  signal=evidence.get("signal"), score=evidence.get("score"))
        # freeze the flight recorder with the peer evidence of the demotion
        get_flight_recorder().trigger("fleet.gray", detail=replica.url,
                                      extra={"fleet": evidence})

    def _on_gray_cleared(self, replica: Replica) -> None:
        get_metrics().inc("fleet.gray_recovered")

    def _update_gray_gauge(self) -> None:
        m = get_metrics()
        m.set_gauge("fleet.gray_replicas", sum(1 for r in self.replicas if r.gray))
        m.set_gauge("fleet.outlier_score_max",
                    max((r.outlier_score for r in self.replicas), default=0.0))
        for r in self.replicas:
            m.set_gauge(f"fleet.outlier.{r.idx}", r.outlier_score)

    # ------------------------------------------------------------ probing

    async def probe_once(self) -> None:
        """One sweep: every member's /health concurrently, then (fleet
        detection on) one time-series window and the gray verdict."""
        await asyncio.gather(*(self._probe_replica(r) for r in self.replicas))
        for r in self.replicas:
            self._maybe_finish_drain(r)
        self._update_health_gauge()
        if self.disagg:
            m = get_metrics()
            m.set_gauge("disagg.prefill_replicas",
                        sum(1 for r in self.replicas if r.role == "prefill" and r.servable()))
            m.set_gauge("disagg.decode_replicas",
                        sum(1 for r in self.replicas if r.role != "prefill" and r.servable()))
        if self.gray_mad is not None:
            await self._fleet_scrape()

    async def _fleet_scrape(self) -> None:
        """One fleet window: every servable member's new samples (its
        ``?since=`` cursor) reduced to a signal vector, the router-observed
        forward wall added as ``fwd_ms``, handed to the gray machine."""
        targets = [r for r in self.replicas if r.servable()]
        readings_list = await asyncio.gather(*(self._scrape_timeseries(r) for r in targets))
        readings = {r.url: sig for r, sig in zip(targets, readings_list) if sig}
        for r in targets:
            if r.fwd_acc:
                sig = readings.setdefault(r.url, {})
                sig["fwd_ms"] = sum(r.fwd_acc) / len(r.fwd_acc)
                r.fwd_acc = []
        self.apply_fleet_window(readings)
        get_metrics().inc("fleet.scrapes")

    async def _scrape_timeseries(self, r: Replica) -> dict | None:
        """One member's time-series delta reduced to a signal vector (None
        on an error or nothing new); updates its cursor and its clock-skew
        estimate (server ``now_s`` minus the request's local midpoint)."""
        try:
            t0 = time.time()
            resp = await self._http.get(r.url + f"{TIMESERIES_ROUTE}?since={r.ts_seq}",
                                        timeout=self.probe_timeout_s)
            t1 = time.time()
            if resp.status_code != 200:
                return None
            body = resp.json()
        except (*_TRANSPORT, ValueError):
            return None
        if not isinstance(body, dict):
            return None
        now_s = body.get("now_s")
        if isinstance(now_s, (int, float)):
            r.clock_skew_s = float(now_s) - (t0 + t1) / 2
        next_seq = body.get("next_seq")
        if isinstance(next_seq, int):
            r.ts_seq = next_seq
        samples = body.get("samples") or []
        return reduce_window([s for s in samples if isinstance(s, dict)])

    async def _probe_replica(self, r: Replica) -> None:
        try:
            resp = await self._http.get(r.url + "/health", timeout=self.probe_timeout_s)
            body = resp.json()
            ok = resp.status_code == 200 and bool(body.get("ok", True))
        except (*_TRANSPORT, ValueError, AttributeError):
            ok, body = False, None
        if ok and isinstance(body, dict):
            # the shed signal rides the probe: the member's pressure score
            p = body.get("pressure")
            try:
                r.pressure = float(p.get("score", 0.0)) if isinstance(p, dict) else 0.0
            except (TypeError, ValueError):
                r.pressure = 0.0
        self.apply_probe(r, ok, body)

    async def _probe_loop(self) -> None:
        while True:
            try:
                await self.probe_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - the prober must never die
                log.exception("probe sweep failed")
            await asyncio.sleep(self.probe_s)

    # --------------------------------------------------------- forwarding

    async def _forward(self, replica: Replica, raw: bytes, headers: dict, deadline: Deadline):
        replica.inflight += 1
        t0 = time.perf_counter()
        try:
            resp = await self._http.post(
                replica.url + "/parse", content=raw,
                headers={**headers, "Content-Type": "application/json",
                         DEADLINE_HEADER: deadline.header_value()},
                timeout=max(0.05, deadline.remaining_s()))
            # the router-observed forward wall: the fleet detector's fwd_ms
            replica.fwd_acc.append((time.perf_counter() - t0) * 1e3)
            if len(replica.fwd_acc) > 512:
                del replica.fwd_acc[:256]
            return resp
        finally:
            # one step: the decrement and the drain check
            replica.inflight -= 1
            self._maybe_finish_drain(replica)

    async def _guarded(self, replica: Replica, raw: bytes, headers: dict, deadline: Deadline,
                       budget_s: float):
        """One forward bounded by ``budget_s`` and cancelled early when the
        member is ejected mid-flight; the outcome goes to its breaker."""
        task = asyncio.ensure_future(self._forward(replica, raw, headers, deadline))
        end = time.monotonic() + budget_s
        try:
            while True:
                left = end - time.monotonic()
                if left <= 0:
                    task.cancel()
                    replica.breaker.record_failure()
                    raise ReplicaFailed(f"{replica.url}: attempt exceeded its budget")
                done, _ = await asyncio.wait({task}, timeout=min(0.25, left))
                if done:
                    break
                if not replica.servable():
                    task.cancel()  # ejected by the prober: no extra breaker count
                    raise ReplicaFailed(f"{replica.url}: ejected mid-flight")
        except asyncio.CancelledError:
            task.cancel()  # our caller was torn down: drop the forward too
            raise
        try:
            resp = task.result()
        except asyncio.CancelledError:
            replica.breaker.record_failure()
            raise ReplicaFailed(f"{replica.url}: forward cancelled") from None
        except _TRANSPORT as e:
            replica.breaker.record_failure()
            raise ReplicaFailed(f"{replica.url}: {type(e).__name__}: {e}") from e
        # any answer is transport health; a 5xx but 503 (a shed) counts against it
        if resp.status_code >= 500 and resp.status_code != 503:
            replica.breaker.record_failure()
        else:
            replica.breaker.record_success()
        return resp

    async def _attempt(self, home: Replica, session_id: str | None, raw: bytes, headers: dict,
                       deadline: Deadline, budget_s: float, idempotent: bool):
        """The primary forward, hedged for an idempotent parse still
        unanswered after ``ROUTER_HEDGE_MS``. Returns (response, served
        replica, hedged)."""
        primary = asyncio.ensure_future(self._guarded(home, raw, headers, deadline, budget_s))
        try:
            return await self._attempt_inner(primary, home, session_id, raw, headers, deadline,
                                             idempotent)
        except asyncio.CancelledError:
            # the caller vanished: cancelling the forward closes its socket,
            # which cancels the member's decode
            primary.cancel()
            raise

    async def _attempt_inner(self, primary, home: Replica, session_id: str | None, raw: bytes,
                             headers: dict, deadline: Deadline, idempotent: bool):
        if not (self.hedge_ms > 0 and idempotent):
            return await primary, home, False
        done, _ = await asyncio.wait({primary}, timeout=self.hedge_ms / 1e3)
        if done:
            return primary.result(), home, False
        alt = self._pick(session_id, exclude={home.url})
        if alt is None:
            return await primary, home, False
        get_metrics().inc("router.hedges_fired")
        secondary = asyncio.ensure_future(
            self._guarded(alt, raw, headers, deadline, max(0.05, deadline.remaining_s())))
        tasks = {primary: home, secondary: alt}
        pending = set(tasks)
        winner = fallback = None
        last_exc: Exception | None = None
        try:
            while pending and winner is None:
                done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    try:
                        resp = t.result()
                    except ReplicaFailed as e:
                        last_exc = e
                        continue
                    if resp.status_code >= 500 and pending:
                        # the first USABLE answer wins: a shed from one
                        # member waits while the other may still succeed
                        if fallback is None:
                            fallback = (resp, tasks[t], True)
                        continue
                    winner = (resp, tasks[t], True)
                    break
        finally:
            for t in pending:
                t.cancel()  # the losing attempt: cancelled, not abandoned
        if winner is None:
            winner = fallback
        if winner is None:
            raise last_exc or ReplicaFailed("all hedged attempts failed")
        if winner[1] is alt:
            get_metrics().inc("router.hedges_won")
        return winner

    # ------------------------------------------------------------ handoff

    async def _rehome_handoff(self, session_id: str, old_url: str, new: Replica,
                              deadline: Deadline) -> bool:
        """A forced move happened: ship the session's warm state from the
        old home to the new one when ``HANDOFF_ENABLE`` is on, and count the
        move warm or cold. Best-effort: every failure is a cold move."""
        warm = False
        if self.handoff_enable:
            warm = await self._ship_warm_state(session_id, old_url, new.url, deadline)
        get_metrics().inc("router.sessions_rehomed_warm" if warm
                          else "router.sessions_rehomed_cold")
        return warm

    async def _ship_warm_state(self, session_id: str, old_url: str, new_url: str,
                               deadline: Deadline) -> bool:
        """GET the donor's session blob, POST it to the new home, each hop
        bounded by HANDOFF_TIMEOUT_S and a third of the remaining budget.
        True only when the recipient adopted KV (``adopted_tokens`` > 0)."""
        budget = min(self.handoff_timeout_s, max(0.05, deadline.remaining_s() / 3))
        sid = urllib.parse.quote(session_id, safe="")
        try:
            resp = await self._http.get(old_url + "/admin/handoff/" + sid, timeout=budget)
            if resp.status_code != 200 or not resp.content:
                return False
            content = resp.content
            if self.handoff_framed:
                # the same sequence-numbered, CRC-checked frames the disagg
                # stream uses; the adopt endpoint reassembles them
                from ..serve.handoff import frame_split

                content = b"".join(frame_split(content, 256 << 10))
            resp2 = await self._http.post(new_url + "/admin/handoff", content=content,
                                          headers={"Content-Type": "application/octet-stream"},
                                          timeout=budget)
            if resp2.status_code != 200:
                return False
            return int(resp2.json().get("adopted_tokens", 0)) > 0
        except (*_TRANSPORT, ValueError, AttributeError):
            return False

    async def prewarm_member(self, replica: Replica, budget_s: float) -> int:
        """Pre-warm a JOINING member: ship the most recently active sticky
        session's warm state from a servable donor to it, so the shared
        prompt root is hot before its first placed session. Returns the
        adopted token count (0: nothing shippable; the caller decides)."""
        donor_sid = donor_url = None
        for sid, url in reversed(self._sessions.items()):
            d = self._by_url.get(url)
            if d is not None and d is not replica and d.servable():
                donor_sid, donor_url = sid, url
                break
        if donor_sid is None:
            return 0
        sid_q = urllib.parse.quote(donor_sid, safe="")
        try:
            resp = await self._http.get(donor_url + "/admin/handoff/" + sid_q, timeout=budget_s)
            if resp.status_code != 200 or not resp.content:
                return 0
            resp2 = await self._http.post(replica.url + "/admin/handoff", content=resp.content,
                                          headers={"Content-Type": "application/octet-stream"},
                                          timeout=budget_s)
            if resp2.status_code != 200:
                return 0
            return int(resp2.json().get("adopted_tokens", 0))
        except (*_TRANSPORT, ValueError, AttributeError):
            return 0

    # ------------------------------------------- disagg orchestration

    def _pick_prefill(self, exclude=()) -> Replica | None:
        """The least-loaded admitting prefill-pool member."""
        pool = [r for r in self.replicas
                if r.role == "prefill" and r.admitting() and r.url not in exclude]
        if not pool:
            return None
        return min(pool, key=lambda r: r.inflight)

    def _note_session_tokens(self, session_id: str | None, served_url: str, resp) -> None:
        """Record a served parse's (home, prompt, cached) token headers: the
        uncached-prompt estimator's memory, capped like the session table."""
        if not session_id or resp is None:
            return
        try:
            pt = int(resp.headers.get("x-prompt-tokens", ""))
        except (TypeError, ValueError):
            return
        try:
            ct = int(resp.headers.get("x-cached-tokens", "0") or 0)
        except (TypeError, ValueError):
            ct = 0
        self._session_tokens[session_id] = (served_url, pt, ct)
        while len(self._session_tokens) > self.max_sessions:
            self._session_tokens.pop(next(iter(self._session_tokens)))

    def _uncached_estimate(self, session_id: str | None, body: dict) -> int:
        """The uncached prompt tokens this parse will likely admit on its
        decode home: the session's last answer anchors the known part, the
        new text adds ~len/4; a session whose home moved counts its whole
        last prompt."""
        text = str(body.get("text") or "")
        ctx = body.get("context")
        est_new = (len(text) + (len(str(ctx)) if ctx else 0)) // 4 + 8
        if not session_id:
            return est_new
        rec = self._session_tokens.get(session_id)
        if rec is None:
            return est_new
        url, prompt_toks, cached_toks = rec
        if self._sessions.get(session_id) != url:
            return prompt_toks + est_new
        return max(0, prompt_toks - cached_toks) + est_new

    async def _adopt_one(self, home: Replica, stream_id: str, blob: bytes) -> dict | None:
        """POST one stream blob to the decode home's adopter (None on any
        failure: the caller aborts the stream)."""
        try:
            resp = await self._http.post(
                home.url + "/admin/disagg/adopt", content=blob,
                headers={"Content-Type": "application/octet-stream",
                         "x-disagg-stream": stream_id},
                timeout=self.handoff_timeout_s)
            if resp.status_code != 200:
                return None
            return resp.json()
        except (*_TRANSPORT, ValueError):
            return None

    async def _disagg_stream(self, pf: Replica, home: Replica, body: dict,
                             deadline: Deadline) -> dict | None:
        """Run one export on ``pf`` and pump its frames into the home's
        adopter as they arrive. Returns the final adopt summary, or None on
        any failure (the caller forwards plainly: clean or cold)."""
        from ..serve.handoff import frame_feed, pack_kv_end

        m = get_metrics()
        stream_id = new_trace_id()
        # leave room for the forward behind it: at most 60% of the budget
        budget = max(0.05, deadline.remaining_s() * 0.6)
        t_end = time.monotonic() + budget
        payload = {"text": str(body.get("text") or ""), "context": body.get("context") or {},
                   "session_id": body.get("session_id") or None, "stream": stream_id,
                   "stream_blocks": self.disagg_stream_blocks}
        pf.inflight += 1
        self._disagg_inflight += 1
        m.set_gauge("disagg.prefill_queue", float(self._disagg_inflight))
        final_out: dict | None = None
        adopted_any = False
        try:
            async with self._http.stream("POST", pf.url + "/admin/disagg/prefill",
                                         json=payload, timeout=budget) as resp:
                if resp.status_code != 200:
                    return None
                if "x-disagg-stream" not in resp.headers:
                    # shed before any segment: a JSON body, nothing to abort
                    await resp.aread()
                    return None
                buf = b""
                saw_final = False
                async for chunk in resp.aiter_bytes():
                    buf += chunk
                    frames, buf = frame_feed(buf)
                    for _seq, blob, final in frames:
                        if time.monotonic() > t_end:
                            return None
                        out = await self._adopt_one(home, stream_id, blob)
                        if out is None or not out.get("ok", False):
                            return None
                        adopted_any = True
                        m.inc("disagg.frames_streamed")
                        self._stream_win.append((time.monotonic(), int(out.get("blocks", 0))))
                        if final:
                            saw_final = True
                            final_out = out
                if buf or not saw_final:
                    return None  # a torn tail, or the stream died before FINAL
        except _TRANSPORT:
            # the prefill member died mid-stream: evidence for its breaker
            pf.breaker.record_failure()
            return None
        except ValueError:
            return None  # a corrupt frame (bad magic or CRC): abort clean
        finally:
            # one step: the decrement and the drain check
            pf.inflight -= 1
            self._maybe_finish_drain(pf)
            self._disagg_inflight -= 1
            m.set_gauge("disagg.prefill_queue", float(self._disagg_inflight))
            if adopted_any and final_out is None:
                # close the home's adopter now: it commits the partial
                # frontier as warm cache and frees every held block
                try:
                    await self._adopt_one(home, stream_id,
                                          pack_kv_end(stream_id, {"ok": False, "aborted": True}))
                except Exception:  # noqa: BLE001 - best-effort close
                    pass
        pf.breaker.record_success()
        adopted = int(final_out.get("adopted_tokens", 0) or 0)
        if adopted > 0:
            m.inc("disagg.tokens_prewarmed", float(adopted))
        return final_out

    def disagg_stats(self) -> dict:
        """The /health roll-up per pool: member counts, the export queue
        depth and streamed KV blocks a second over 30 s."""
        now = time.monotonic()
        while self._stream_win and now - self._stream_win[0][0] > 30.0:
            self._stream_win.popleft()
        blocks = sum(n for _, n in self._stream_win)
        pf = [r for r in self.replicas if r.role == "prefill"]
        dec = [r for r in self.replicas if r.role != "prefill"]
        return {"enabled": self.disagg, "min_tokens": self.disagg_min_tokens,
                "stream_blocks": self.disagg_stream_blocks,
                "prefill": {"total": len(pf), "admitting": sum(1 for r in pf if r.admitting()),
                            "queue_depth": self._disagg_inflight, "urls": [r.url for r in pf]},
                "decode": {"total": len(dec), "admitting": sum(1 for r in dec if r.admitting())},
                "streamed_blocks_per_s": round(blocks / 30.0, 3)}

    async def forward_parse(self, raw: bytes, body: dict, headers: dict) -> tuple:
        """The /parse policy: route -> (a forced move: the warm handoff) ->
        (disagg) -> the (hedged) attempt -> on a transport failure one retry
        on the session's new home inside the deadline (speculative parses
        and feeds are discarded instead). Returns (response | None, served
        replica | None, error | None)."""
        session_id = body.get("session_id") or None
        speculative = bool(body.get("speculative"))
        # a prefix feed follows affinity but is never hedged or replayed
        feed = bool(body.get("prefix_feed"))
        deadline = Deadline.from_headers(headers) or Deadline.after(self.parse_timeout_s)
        idempotent = (speculative or not session_id) and not feed
        home, rehomed_from = self.route_ex(session_id)
        if home is None:
            return None, None, "no_replicas"
        if rehomed_from is not None and session_id:
            await self._rehome_handoff(session_id, rehomed_from, home, deadline)
        if self.disagg:
            pf = self._pick_prefill(exclude={home.url})
            if pf is not None and speculative:
                # throwaway work: run it on the prefill pool, never replayed
                get_metrics().inc("disagg.spec_routed")
                try:
                    resp = await self._guarded(pf, raw, headers, deadline,
                                               max(0.05, deadline.remaining_s()))
                    return resp, pf, None
                except ReplicaFailed:
                    get_metrics().inc("router.spec_discarded")
                    return None, None, "spec_discarded"
            if pf is not None and feed:
                # a feed IS a prefill-only admission: export it on the pool,
                # land the chain on the session's decode home
                out = await self._disagg_stream(pf, home, body, deadline)
                if out is not None:
                    get_metrics().inc("disagg.feeds_routed")
                    body = {"prefix_feed": True, "ok": True, "disagg": True,
                            "adopted_tokens": int(out.get("adopted_tokens", 0) or 0)}
                    return wslib.HTTPResponse(
                        200, wslib.Headers({"Content-Type": "application/json"}),
                        json.dumps(body).encode()), home, None
                get_metrics().inc("disagg.fallbacks")
            elif pf is not None and not speculative \
                    and self._uncached_estimate(session_id, body) >= self.disagg_min_tokens:
                # a long cold admission: prefill it on the pool; the forward
                # below runs warm on success, cold on a fallback
                get_metrics().inc("disagg.admissions")
                if await self._disagg_stream(pf, home, body, deadline) is None:
                    get_metrics().inc("disagg.fallbacks")
        # with a retry possible, the first attempt takes at most half the
        # remaining budget, so the retry fits
        can_retry = (not speculative and not feed
                     and any(r.admitting() and r.url != home.url for r in self.replicas))
        remaining = deadline.remaining_s()
        budget = remaining * 0.5 if can_retry else remaining
        try:
            resp, served, _hedged = await self._attempt(home, session_id, raw, headers,
                                                        deadline, max(0.05, budget), idempotent)
            if self.disagg:
                self._note_session_tokens(session_id, served.url, resp)
            return resp, served, None
        except ReplicaFailed as e:
            if speculative:
                # discarded, never replayed: the final re-routes and parses
                get_metrics().inc("router.spec_discarded")
                return None, None, "spec_discarded"
            if feed:
                get_metrics().inc("router.feeds_discarded")
                return None, None, "feed_discarded"
            if deadline.expired:
                return None, None, f"deadline_expired: {e}"
            home2, rehomed2 = self.route_ex(session_id, exclude={home.url})
            if home2 is None:
                return None, None, "no_replicas"
            if rehomed2 is not None and session_id:
                await self._rehome_handoff(session_id, rehomed2, home2, deadline)
            get_metrics().inc("router.retries")
            try:
                resp, served, _h = await self._attempt(
                    home2, session_id, raw, headers, deadline,
                    max(0.05, deadline.remaining_s()), idempotent=False)
                if self.disagg:
                    self._note_session_tokens(session_id, served.url, resp)
                return resp, served, None
            except ReplicaFailed as e2:
                return None, None, f"retry_failed: {e2}"

    # ------------------------------------------------------------- fanout

    async def fan_out_get(self, path: str, query: str = "") -> dict:
        """GET ``path`` on every member; bodies keyed by url (an
        unreachable member reports an ``error`` entry)."""

        async def one(r: Replica):
            try:
                resp = await self._http.get(r.url + path + (f"?{query}" if query else ""),
                                            timeout=self.probe_timeout_s)
                return r.url, resp.json()
            except (*_TRANSPORT, ValueError) as e:
                return r.url, {"error": f"{type(e).__name__}: {e}"}

        return dict(await asyncio.gather(*(one(r) for r in self.replicas)))

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._http is None:
            self._http = wslib.HTTPClient()
        if self._probe_task is None:
            await self.probe_once()  # the first routing decision sees real state
            self._probe_task = asyncio.ensure_future(self._probe_loop())

    async def stop(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._probe_task = None
        self._http = None


# ------------------------------------------------------------------- app

_FANOUTS = {"/debug/replicas/steplog": "/debug/steplog",
            "/debug/replicas/timeseries": TIMESERIES_ROUTE,
            "/debug/replicas/quality": "/debug/quality",
            "/debug/replicas/costs": "/debug/costs"}
_REPLICA_TRACE = "/debug/replicas/trace/"
# served routes: path -> method (a prefix when it ends in "/")
_ROUTES = {"/parse": "POST", "/health": "GET", "/admin/drain": "POST", "/admin/admit": "POST",
           "/admin/autopilot": "GET", "/metrics": "GET", TRACE_ROUTE: "GET",
           _REPLICA_TRACE: "GET", "/debug/replicas/flightrecorder": "GET",
           "/debug/flightrecorder": "GET", TIMESERIES_ROUTE: "GET",
           **{k: "GET" for k in _FANOUTS}}


def _route_of(path: str) -> str | None:
    for p in _ROUTES:
        if p.endswith("/") and path.startswith(p) and len(path) > len(p):
            return p
        if path == p:
            return p
    return None


def _json_body(req: wslib.Request) -> dict:
    try:
        body = json.loads(req.body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError):
        return {}
    return body if isinstance(body, dict) else {}


def build_app(router: BrainRouter, tracer: Tracer | None = None) -> wslib.App:
    """The router's HTTP app: ``ws.serve`` it (its startup hook starts the
    prober and the time-series sampler; ``ws.stop`` stops both)."""
    tracer = tracer or Tracer("router", emit=False)
    slo = SLOTracker("router")
    ring = service_ring("router", tracer)

    async def on_startup() -> None:
        await router.start()
        ring.start()

    async def on_cleanup() -> None:
        ring.stop()
        await router.stop()

    async def parse(req: wslib.Request) -> wslib.Response:
        t0 = time.perf_counter()
        resp = await _parse_inner(req)
        slo.record((time.perf_counter() - t0) * 1e3, ok=resp.status < 500)
        return resp

    async def _parse_inner(req: wslib.Request) -> wslib.Response:
        trace_id = req.headers.get("x-trace-id") or new_trace_id()
        headers = {"x-trace-id": trace_id}
        raw = req.body
        if len(raw) > MAX_BODY_BYTES:
            return wslib.Response(413, {"error": "request_too_large",
                                        "limit_bytes": MAX_BODY_BYTES}, headers)
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return wslib.Response(400, {"error": "invalid_request",
                                        "detail": "body must be JSON"}, headers)
        fwd_headers = dict(headers)
        if req.headers.get(DEADLINE_HEADER) is not None:
            fwd_headers[DEADLINE_HEADER] = req.headers[DEADLINE_HEADER]
        if req.headers.get("x-tenant") is not None:
            # the body's tenant rides the raw bytes; the header goes by hand
            fwd_headers["x-tenant"] = req.headers["x-tenant"]
        with tracer.span("route_parse", trace_id=trace_id) as sp:
            resp, served, err = await router.forward_parse(
                raw, body if isinstance(body, dict) else {}, fwd_headers)
            if served is not None:
                sp.attrs["replica"] = served.url
            if err is not None:
                sp.attrs["error"] = err
        if resp is None:
            if err == "spec_discarded":
                # a semantic answer, not dependency health: 409 keeps the
                # voice service's breaker closed for the final
                return wslib.Response(409, {"error": "speculation_discarded",
                                            "detail": "home replica failed mid-speculation; "
                                                      "parse at final"}, headers)
            if err == "feed_discarded":
                return wslib.Response(409, {"error": "prefix_feed_discarded",
                                            "detail": "home replica failed mid-feed; "
                                                      "final will cold-prefill"}, headers)
            # full outage or a failed failover: the shed contract
            return shed_response("router",
                                 "no_replicas" if err == "no_replicas" else "replica_failed",
                                 headers=headers, retry_after_s=max(1.0, 2 * router.probe_s))
        out_headers = {k: v for k, v in resp.headers.items() if k.lower() in _PASS_HEADERS}
        out_headers["x-trace-id"] = trace_id
        out_headers["x-router-replica"] = served.url
        out_headers["Content-Type"] = resp.headers.get("Content-Type", "application/json")
        return wslib.Response(resp.status_code, resp.content, out_headers)

    def health() -> wslib.Response:
        total = len(router.replicas)
        healthy = sum(1 for r in router.replicas if r.servable())
        draining = sum(1 for r in router.replicas if r.state == "draining")
        gray = sum(1 for r in router.replicas if r.gray)
        status = "ok" if healthy == total else "unhealthy" if healthy == 0 else "degraded"
        body = {"ok": healthy > 0, "service": "router", "status": status,
                "replicas": {"total": total, "healthy": healthy, "draining": draining,
                             "gray": gray},
                "replica_detail": [r.describe() for r in router.replicas],
                "slo": slo.state()}
        if router.last_fleet is not None:
            body["fleet"] = router.last_fleet
        if router.disagg:
            body["disagg"] = router.disagg_stats()
        # the engine view of a representative healthy member rides along,
        # so the voice /health forward keeps it behind the router
        for r in router.replicas:
            if r.servable() and r.last_health:
                for k in ("compile_sentinel", "last_step", "hbm", "quarantine", "quality"):
                    if r.last_health.get(k) is not None:
                        body[k] = r.last_health[k]
                body["home_replica"] = r.url
                break
        return wslib.Response(200 if body["ok"] else 503, body)

    async def admin_drain(req: wslib.Request) -> wslib.Response:
        target = _json_body(req).get("replica")
        r = router._by_url.get(str(target).rstrip("/")) if target else None
        if r is None and isinstance(target, int) and 0 <= target < len(router.replicas):
            r = router.replicas[target]
        if r is None:
            return wslib.Response(404, {"error": "unknown_replica", "detail": str(target),
                                        "replicas": [x.url for x in router.replicas]})
        started = router.start_drain(r)
        # forward the drain to the member itself (best-effort)
        try:
            await router._http.post(r.url + "/admin/drain", timeout=router.probe_timeout_s)
        except _TRANSPORT:
            pass
        return wslib.Response(200, {"ok": True, "replica": r.url, "state": r.state,
                                    "started": started})

    def admin_admit(req: wslib.Request) -> wslib.Response:
        r = router._by_url.get(str(_json_body(req).get("replica", "")).rstrip("/"))
        if r is None:
            return wslib.Response(404, {"error": "unknown_replica"})
        router.admit(r)
        return wslib.Response(200, {"ok": True, "replica": r.url, "state": r.state})

    def admin_autopilot() -> wslib.Response:
        """The autopilot's state and decision log; 404 without one."""
        ap = router.autopilot
        if ap is None:
            return wslib.Response(404, {"enabled": False, "detail": "no autopilot attached"})
        return wslib.Response(200, ap.describe())

    async def replicas_flight(req: wslib.Request) -> wslib.Response:
        """The members' flight dumps, each annotated with the router's
        clock-skew estimate for it (what merges dumps onto one clock)."""
        bodies = await router.fan_out_get("/debug/flightrecorder", req.query)
        for r in router.replicas:
            b = bodies.get(r.url)
            if isinstance(b, dict):
                b["clock_skew_s"] = round(r.clock_skew_s, 6)
        return wslib.Response(200, {"service": "router", "replicas": bodies})

    async def route(req: wslib.Request) -> wslib.Response:
        key = _route_of(req.path)
        if key is None:
            return wslib.Response(404, {"error": "not_found", "detail": req.path})
        if req.method != _ROUTES[key]:
            return wslib.Response(405, {"error": "method_not_allowed", "detail": req.method})
        if key == "/parse":
            return await parse(req)
        if key == "/health":
            return health()
        if key == "/admin/drain":
            return await admin_drain(req)
        if key == "/admin/admit":
            return admin_admit(req)
        if key == "/admin/autopilot":
            return admin_autopilot()
        if key == "/metrics":
            return metrics_response("router", tracer, req, slo=slo)
        if key == TRACE_ROUTE:
            return trace_response("router", tracer, req)
        if key == "/debug/flightrecorder":
            return flightrecorder_response("router", req)
        if key == TIMESERIES_ROUTE:
            return timeseries_response(ring, req)
        if key == "/debug/replicas/flightrecorder":
            return await replicas_flight(req)
        if key == _REPLICA_TRACE:
            path = TRACE_ROUTE + req.path[len(_REPLICA_TRACE):]
        else:
            path = _FANOUTS[key]
        return wslib.Response(200, {"service": "router",
                                    "replicas": await router.fan_out_get(path, req.query)})

    app = wslib.App(http=route, websockets={}, on_startup=[on_startup],
                    on_cleanup=[on_cleanup])
    app.ring = ring
    return app


class RouterThread:
    """A router embedded in another program (the CPU tests, the card's
    fleet drill): ``BrainRouter(urls, **kw)`` behind ``build_app`` on a
    ``ws.ServerThread``. ``on_loop`` runs a coroutine on its event loop,
    where all ring state lives, and ``probe`` runs prober sweeps there.
    ``probe_s`` defaults to an hour: the prober sweeps once at start, and
    every later probe and fleet window is one the caller drives."""

    def __init__(self, urls: list[str], **kw):
        kw.setdefault("probe_s", 3600.0)
        self.robj = BrainRouter(urls, **kw)
        self.srv = wslib.ServerThread(build_app(self.robj)).__enter__()
        self.url = self.srv.url

    def on_loop(self, coro, timeout_s: float = 600.0):
        return asyncio.run_coroutine_threadsafe(coro, self.srv.loop).result(timeout_s)

    def probe(self, n: int = 1) -> None:
        for _ in range(n):
            self.on_loop(self.robj.probe_once())

    def member(self, url: str) -> Replica | None:
        return self.robj._by_url.get(url.rstrip("/"))

    def close(self) -> None:
        self.srv.__exit__(None, None, None)


def replicas_from_env() -> list[str]:
    spec = os.environ.get("BRAIN_REPLICAS", "")
    return [u.strip() for u in spec.split(",") if u.strip()]


async def _serve_forever(app: wslib.App, port: int) -> None:
    server = await wslib.serve(app, "0.0.0.0", port)
    print(f"router: serving /parse on :{server.sockets[0].getsockname()[1]}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await wslib.stop(server)


def main() -> None:
    # the repo-root .env first: its knobs are served like the environment's
    load_env_cascade()
    urls = replicas_from_env()
    if not urls:
        raise SystemExit("BRAIN_REPLICAS=url,url,... is required")
    port = int(os.environ.get("ROUTER_PORT", "8095"))
    asyncio.run(_serve_forever(build_app(BrainRouter(urls), Tracer("router")), port))


if __name__ == "__main__":
    main()
