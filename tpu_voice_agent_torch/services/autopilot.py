"""The fleet autopilot: closed-loop elastic capacity.

Port of ``tpu_voice_agent/services/autopilot.py``. It watches the members'
time-series rings (``/debug/timeseries?since=`` deltas, through its own
cursors), forecasts near-future load and grows or shrinks the brain tier
(and, given one, the in-process STT tier and the disagg prefill pool),
bounded, damped and without dropping a request. One ``tick_once`` every
``AUTOPILOT_INTERVAL_S``:

1. **Measure.** Each servable member's window is reduced to a busy fraction
   (``brain.parse`` ``ms_per`` x ``per_s`` / 1000); fleet load is the sum.
2. **Forecast.** A least-squares slope over the recent load, extrapolated
   ``AUTOPILOT_FORECAST_LEAD_S`` ahead; demand = max(now, forecast), and the
   desired capacity ceil(demand / ``AUTOPILOT_TARGET_UTIL``) clamped to
   [``AUTOPILOT_MIN_REPLICAS``, ``AUTOPILOT_MAX_REPLICAS``]. A fleet mean
   pressure at the router's shed threshold asks for one more.
3. **Damp.** ``AUTOPILOT_UP_WINDOWS`` over-target ticks commit +1,
   ``AUTOPILOT_DOWN_WINDOWS`` under-target ticks commit -1, and each commit
   arms ``AUTOPILOT_COOLDOWN_S``. A tick with no fresh sample holds.
4. **Reconcile.** Scale-up = spawn -> join (no placement) -> pre-warm
   (``BrainRouter.prewarm_member``: a sticky session's warm state shipped
   over the handoff wire) -> admit, inside ``AUTOPILOT_JOIN_TIMEOUT_S``; a
   timeout retires the member, and one claimed by a manual drain is never
   admitted. Scale-down = drain -> ship each sticky session's warm state to
   its next home -> leave the ring at zero in flight -> ``retire``.

The spawner is duck-typed: ``async spawn() -> url`` boots a replica and
returns its base URL, ``async retire(url)`` tears it down; the tests and
``chip_smoke.py``'s fleet phase implement it over in-process port brains.
Every decision lands in a bounded log (``describe()``, served at ``GET
/admin/autopilot``), a ``log_event`` line and the ``autopilot.*`` series.
"""

from __future__ import annotations

import asyncio
import logging
import math
import os
import time

from ..utils.timeseries import TIMESERIES_ROUTE
from ..utils.tracing import get_metrics, log_event
from .replicaset import Replica
from .resilience import Deadline
from .router import _TRANSPORT, BrainRouter

log = logging.getLogger("tpu_voice_agent_torch.autopilot")

_DECISION_LOG_MAX = 64

# the AUTOPILOT_* knobs and JAX's defaults (tpu_voice_agent/utils/knobs.py)
KNOB_DEFAULTS = {"AUTOPILOT_MIN_REPLICAS": "1", "AUTOPILOT_MAX_REPLICAS": "4",
                 "AUTOPILOT_INTERVAL_S": "1.0", "AUTOPILOT_TARGET_UTIL": "0.6",
                 "AUTOPILOT_UP_WINDOWS": "2", "AUTOPILOT_DOWN_WINDOWS": "5",
                 "AUTOPILOT_COOLDOWN_S": "5.0", "AUTOPILOT_JOIN_TIMEOUT_S": "15",
                 "AUTOPILOT_FORECAST_LEAD_S": "5.0"}


def knob_int(name: str) -> int:
    return int(os.environ.get(name) or KNOB_DEFAULTS[name])


def knob_float(name: str) -> float:
    return float(os.environ.get(name) or KNOB_DEFAULTS[name])


class AutopilotController:
    """The closed-loop capacity controller. Pure asyncio, no threads of
    its own (the STT resize, which joins batcher workers, runs
    on the default executor so the control loop never blocks the event
    loop). Tests drive ``tick_once`` directly for
    deterministic decisions; ``start()`` runs the same tick on a
    background task at ``AUTOPILOT_INTERVAL_S``."""

    def __init__(self, router: BrainRouter, spawner, *,
                 stt_tier=None,
                 min_replicas: int | None = None,
                 max_replicas: int | None = None,
                 interval_s: float | None = None,
                 target_util: float | None = None,
                 up_windows: int | None = None,
                 down_windows: int | None = None,
                 cooldown_s: float | None = None,
                 join_timeout_s: float | None = None,
                 forecast_lead_s: float | None = None):
        self.router = router
        self.spawner = spawner
        self.stt_tier = stt_tier
        self.min = min_replicas if min_replicas is not None \
            else knob_int("AUTOPILOT_MIN_REPLICAS")
        self.max = max_replicas if max_replicas is not None \
            else knob_int("AUTOPILOT_MAX_REPLICAS")
        if not 1 <= self.min <= self.max:
            raise ValueError(
                f"need 1 <= min ({self.min}) <= max ({self.max})")
        self.interval_s = interval_s if interval_s is not None \
            else knob_float("AUTOPILOT_INTERVAL_S")
        self.target_util = target_util if target_util is not None \
            else knob_float("AUTOPILOT_TARGET_UTIL")
        self.up_windows = up_windows if up_windows is not None \
            else knob_int("AUTOPILOT_UP_WINDOWS")
        self.down_windows = down_windows if down_windows is not None \
            else knob_int("AUTOPILOT_DOWN_WINDOWS")
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else knob_float("AUTOPILOT_COOLDOWN_S")
        self.join_timeout_s = join_timeout_s if join_timeout_s is not None \
            else knob_float("AUTOPILOT_JOIN_TIMEOUT_S")
        self.forecast_lead_s = forecast_lead_s if forecast_lead_s is not None \
            else knob_float("AUTOPILOT_FORECAST_LEAD_S")
        self.target = max(self.min, min(self.max, len(router.replicas)))
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0
        # controller-owned timeseries delta cursors, url -> next seq. The
        # fleet scrape owns r.ts_seq; sharing it would make each reader
        # starve the other of deltas.
        self._cursors: dict[str, int] = {}
        self._history: list[tuple[float, float]] = []
        self._last_busy = 0.0
        self._last_forecast = 0.0
        # members the controller drained and still owes a spawner.retire
        self._retiring: set[str] = set()
        self.decisions: list[dict] = []
        self._task: asyncio.Task | None = None
        # STT tier side-channel (same band controller, separate streaks)
        self.stt_target = len(stt_tier.replicas) if stt_tier is not None else 0
        self._stt_up_streak = 0
        self._stt_down_streak = 0
        self._stt_cooldown_until = 0.0
        # prefill pool side-channel: the disaggregated fleet's
        # prefill members are sized on their OWN band — export-queue
        # depth / member pressure, not the decode tier's parse-busy
        # signal — with their own streaks and cooldown
        self.prefill_target = sum(1 for r in router.replicas
                                  if r.role == "prefill")
        self._prefill_up_streak = 0
        self._prefill_down_streak = 0
        self._prefill_cooldown_until = 0.0
        # contract counters/gauges exist from construction (the breaker
        # gauge discipline: scrape-visible at zero, never absent)
        m = get_metrics()
        m.inc("autopilot.decisions", 0.0)
        m.inc("autopilot.scale_ups", 0.0)
        m.inc("autopilot.scale_downs", 0.0)
        m.inc("autopilot.holds_starved", 0.0)
        m.inc("autopilot.cooldown_blocks", 0.0)
        m.inc("autopilot.join_timeouts", 0.0)
        m.inc("autopilot.joins_prewarmed", 0.0)
        m.inc("autopilot.joins_cold", 0.0)
        m.inc("autopilot.sessions_shipped", 0.0)
        m.inc("autopilot.retired", 0.0)
        m.set_gauge("autopilot.target_replicas", float(self.target))
        m.set_gauge("autopilot.load", 0.0)
        m.set_gauge("autopilot.forecast_load", 0.0)
        if stt_tier is not None:
            m.set_gauge("autopilot.stt_target_replicas", float(self.stt_target))
        if getattr(router, "disagg", False):
            m.set_gauge("autopilot.prefill_target_replicas",
                        float(self.prefill_target))
        # the /admin/autopilot surface finds the controller here
        router.autopilot = self

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                await self.tick_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - the loop must never die
                log.exception("autopilot tick failed")
            await asyncio.sleep(self.interval_s)

    # ------------------------------------------------------------ measure

    async def _read_load(self) -> tuple[float, int]:
        """One measurement window: every servable member's new time-series
        samples through the controller's own delta cursors, reduced to
        fleet busy (sum of per-member parse-wall fractions). Returns
        ``(busy, fresh)`` where fresh counts members that produced at
        least one new sample — 0 means the controller is BLIND this tick
        (rings down, scrape failing) and must hold."""
        busy = 0.0
        fresh = 0
        for r in [x for x in self._brain_members() if x.servable()]:
            since = self._cursors.get(r.url, 0)
            try:
                resp = await self.router._http.get(
                    r.url + f"{TIMESERIES_ROUTE}?since={since}",
                    timeout=self.router.probe_timeout_s)
                if resp.status_code != 200:
                    continue
                body = resp.json()
            except (*_TRANSPORT, ValueError):
                continue
            if not isinstance(body, dict):
                continue
            next_seq = body.get("next_seq")
            if isinstance(next_seq, int):
                self._cursors[r.url] = next_seq
            samples = [s for s in (body.get("samples") or [])
                       if isinstance(s, dict)]
            if not samples:
                continue
            fresh += 1
            vals = []
            for s in samples:
                h = (s.get("hist") or {}).get("brain.parse")
                if isinstance(h, dict):
                    ms, ps = h.get("ms_per"), h.get("per_s")
                    if isinstance(ms, (int, float)) and \
                            isinstance(ps, (int, float)):
                        vals.append(float(ms) * float(ps) / 1000.0)
            # a fresh sample WITHOUT parse activity is a real reading of
            # an idle member (busy 0), not a starved signal
            if vals:
                busy += sum(vals) / len(vals)
        return busy, fresh

    def _slope(self) -> float:
        """Least-squares d(busy)/dt over the retained history."""
        pts = self._history
        if len(pts) < 3:
            return 0.0
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [b for _, b in pts]
        n = float(len(pts))
        mx, my = sum(xs) / n, sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 1e-9:
            return 0.0
        return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den

    # ------------------------------------------------------------- decide

    def _record(self, tier: str, action: str, reason: str, *,
                signal: float | None = None, forecast: float | None = None,
                target: int, actual: int, **extra) -> dict:
        cooldown_until = {"brain": self._cooldown_until,
                          "prefill": self._prefill_cooldown_until,
                          }.get(tier, self._stt_cooldown_until)
        d = {"t": round(time.time(), 3), "tier": tier, "action": action,
             "reason": reason,
             "signal": None if signal is None else round(signal, 4),
             "forecast": None if forecast is None else round(forecast, 4),
             "target": target, "actual": actual,
             "cooldown_remaining_s": round(
                 max(0.0, cooldown_until - time.monotonic()), 3)}
        d.update(extra)
        self.decisions.append(d)
        del self.decisions[:-_DECISION_LOG_MAX]
        get_metrics().inc("autopilot.decisions")
        log_event("autopilot", "autopilot_decision", tier=tier, action=action,
                  reason=reason, signal=d["signal"], forecast=d["forecast"],
                  target=target, actual=actual,
                  cooldown_remaining_s=d["cooldown_remaining_s"])
        return d

    def _brain_members(self) -> list[Replica]:
        """The DECODE-tier members the brain band governs. Prefill-pool
        members are excluded everywhere the brain band
        measures, counts or retires — they are sized by their own band —
        and with disagg off every member's role is "both", so this is the
        whole ring, byte-identical to the pre-disagg controller."""
        return [r for r in self.router.replicas if r.role != "prefill"]

    def _actual(self) -> int:
        """Capacity the ring has or is actively acquiring: up + joining.
        Draining/drained/down members are spent capacity on their way out."""
        return sum(1 for r in self._brain_members()
                   if r.state in ("up", "joining"))

    def _decide(self, desired: int, busy: float, forecast: float) -> None:
        """The hysteresis band: streaks accumulate per direction, commits
        move the target ONE step and arm the cooldown."""
        m = get_metrics()
        if desired > self.target:
            self._up_streak += 1
            self._down_streak = 0
        elif desired < self.target:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
            return
        want_up = self._up_streak >= self.up_windows and self.target < self.max
        want_down = (self._down_streak >= self.down_windows
                     and self.target > self.min)
        if not (want_up or want_down):
            return
        now = time.monotonic()
        if now < self._cooldown_until:
            # the streak is earned but the cooldown holds it: counted and
            # logged as a hold
            m.inc("autopilot.cooldown_blocks")
            self._record("brain", "hold", "cooldown", signal=busy,
                         forecast=forecast, target=self.target,
                         actual=self._actual())
            return
        if want_up:
            self.target += 1
            m.inc("autopilot.scale_ups")
            self._record("brain", "scale_up",
                         "forecast" if forecast > busy else "load",
                         signal=busy, forecast=forecast, target=self.target,
                         actual=self._actual())
        else:
            self.target -= 1
            m.inc("autopilot.scale_downs")
            self._record("brain", "scale_down", "underutilized", signal=busy,
                         forecast=forecast, target=self.target,
                         actual=self._actual())
        self._up_streak = self._down_streak = 0
        self._cooldown_until = now + self.cooldown_s
        m.set_gauge("autopilot.target_replicas", float(self.target))

    # ---------------------------------------------------------- reconcile

    async def _finish_retirements(self) -> None:
        """Step the drain->ship->eject->retire pipeline's tail: a member
        the controller drained leaves the ring (and only then the
        spawner) once it is drained/down with zero inflight — the
        provably-zero-loss gate."""
        for url in sorted(self._retiring):
            r = self.router._by_url.get(url)
            if r is None:
                # someone else removed it (or a prior tick raced us):
                # still owes the spawner its teardown
                self._retiring.discard(url)
                await self._spawner_retire(url)
                continue
            if r.state in ("drained", "down") and r.inflight == 0:
                self.router.remove_member(url)
                self._retiring.discard(url)
                get_metrics().inc("autopilot.retired")
                self._record("brain", "retire", "drain_complete",
                             target=self.target, actual=self._actual(),
                             replica=url)
                await self._spawner_retire(url)

    async def _spawner_retire(self, url: str) -> None:
        try:
            await self.spawner.retire(url)
        except Exception:  # noqa: BLE001 - teardown is best-effort
            log.exception("spawner.retire(%s) failed", url)

    async def _join_one(self) -> None:
        """Scale-up's join pipeline: spawn -> enter joining -> pre-warm ->
        admit, ALL inside ``AUTOPILOT_JOIN_TIMEOUT_S``. On timeout the
        stuck member is retired and the target stands — the next tick's
        reconcile retries; a member claimed by a manual drain mid-join is
        never admitted."""
        m = get_metrics()
        t0 = time.monotonic()
        holder: dict = {}

        async def _spawn_and_prewarm() -> int:
            url = await self.spawner.spawn()
            holder["url"] = url
            r = self.router.add_member(url, joining=True)
            holder["replica"] = r
            # the per-hop handoff budget deliberately EXCEEDS the join
            # budget: a wedged donor/recipient (replica_join_stall) must
            # be the join timeout's verdict — retire and retry — not an
            # client timeout quietly returning 0 and admitting COLD just
            # under the wire
            return await self.router.prewarm_member(
                r, self.join_timeout_s + 1.0)

        try:
            adopted = await asyncio.wait_for(_spawn_and_prewarm(),
                                             self.join_timeout_s)
        except asyncio.TimeoutError:
            m.inc("autopilot.join_timeouts")
            await self._abort_join(holder, "join_timeout")
            return
        except Exception:
            await self._abort_join(holder, "join_failed")
            return
        r: Replica = holder["replica"]
        if r.state != "joining":
            # a manual drain (POST /admin/drain) claimed this member while
            # it pre-warmed: the operator wins the slot — never admit,
            # let the drain pipeline retire it
            self._retiring.add(r.url)
            self._record("brain", "join_aborted", "manual_drain",
                         target=self.target, actual=self._actual(),
                         replica=r.url)
            return
        self.router.admit(r)  # fresh gray/pressure state by contract
        m.inc("autopilot.joins_prewarmed" if adopted > 0
              else "autopilot.joins_cold")
        self._record("brain", "join",
                     "prewarmed" if adopted > 0 else "cold",
                     target=self.target, actual=self._actual(),
                     replica=r.url, adopted_tokens=int(adopted),
                     join_s=round(time.monotonic() - t0, 3))

    async def _abort_join(self, holder: dict, reason: str) -> None:
        r = holder.get("replica")
        if r is not None and self.router._by_url.get(r.url) is r:
            self.router.remove_member(r.url)
        self._record("brain", "join_aborted", reason, target=self.target,
                     actual=self._actual(), replica=holder.get("url"))
        if holder.get("url"):
            await self._spawner_retire(holder["url"])

    async def _scale_down_one(self) -> None:
        """Scale-down's head: pick a victim, stop placement, proactively
        ship its sticky sessions' warm state to their next homes, and
        queue it for retirement (which completes only at inflight==0)."""
        router = self.router
        ups = [r for r in self._brain_members() if r.state == "up"]
        if len(ups) <= self.min:
            return
        sessions_of = {r.url: 0 for r in ups}
        for _sid, url in router._sessions.items():
            if url in sessions_of:
                sessions_of[url] += 1
        grays = [r for r in ups if r.gray]
        pool = grays or ups
        # cheapest exit: fewest sticky sessions, then least saturated,
        # then newest (highest idx) — the seed members outlive elastic ones
        victim = min(pool, key=lambda r: (sessions_of[r.url], r.pressure,
                                          -r.idx))
        if not router.start_drain(victim):
            return  # already draining/drained: an operator got here first
        self._retiring.add(victim.url)
        self._record("brain", "drain", "scale_down", target=self.target,
                     actual=self._actual(), replica=victim.url,
                     sessions=sessions_of[victim.url])
        sids = [sid for sid, url in list(router._sessions.items())
                if url == victim.url]
        m = get_metrics()
        for sid in sids:
            new_home = router._pick(sid, exclude={victim.url})
            if new_home is None:
                continue  # nowhere to ship; lazy re-home will cover it
            warm = await router._ship_warm_state(
                sid, victim.url, new_home.url,
                Deadline.after(router.handoff_timeout_s * 3))
            # atomic-section: autopilot.session-repoint -- the session-table check and repoint must be one event-loop step: a parse racing this ship may already have re-homed (and counted) the session, and stomping its newer home would route the next turn cold
            if router._sessions.get(sid) == victim.url:
                router._sessions[sid] = new_home.url
                router._on_rehome()
                m.inc("router.sessions_rehomed_warm" if warm
                      else "router.sessions_rehomed_cold")
                m.inc("autopilot.sessions_shipped")
            # end-atomic-section
        router._maybe_finish_drain(victim)

    async def _reconcile(self) -> None:
        await self._finish_retirements()
        actual = self._actual()
        joining = sum(1 for r in self.router.replicas
                      if r.state == "joining")
        if actual < self.target and joining == 0:
            await self._join_one()
        elif sum(1 for r in self._brain_members() if r.state == "up") \
                > self.target:
            await self._scale_down_one()

    # ----------------------------------------------------------- stt tier

    async def _tick_stt(self) -> None:
        """The in-process STT ring rides the same band controller on its
        own streaks: signal = mean queue-pressure over servable replicas
        (the shed signal the tier already publishes). The resize itself
        joins batcher threads, so it runs on the default executor."""
        tier = self.stt_tier
        if tier is None:
            return
        servable = [r for r in tier.replicas if r.servable()]
        if not servable:
            return  # blind: hold, exactly like the brain side
        sig = sum(r.pressure for r in servable) / len(servable)
        if sig >= self.target_util:
            self._stt_up_streak += 1
            self._stt_down_streak = 0
        elif sig < self.target_util / 2:
            self._stt_down_streak += 1
            self._stt_up_streak = 0
        else:
            self._stt_up_streak = self._stt_down_streak = 0
        want_up = (self._stt_up_streak >= self.up_windows
                   and self.stt_target < self.max)
        want_down = (self._stt_down_streak >= self.down_windows
                     and self.stt_target > self.min)
        m = get_metrics()
        if want_up or want_down:
            now = time.monotonic()
            if now < self._stt_cooldown_until:
                m.inc("autopilot.cooldown_blocks")
                self._record("stt", "hold", "cooldown", signal=sig,
                             target=self.stt_target,
                             actual=len(tier.replicas))
            else:
                self.stt_target += 1 if want_up else -1
                m.inc("autopilot.scale_ups" if want_up
                      else "autopilot.scale_downs")
                self._record("stt", "scale_up" if want_up else "scale_down",
                             "pressure" if want_up else "underutilized",
                             signal=sig, target=self.stt_target,
                             actual=len(tier.replicas))
                self._stt_up_streak = self._stt_down_streak = 0
                self._stt_cooldown_until = now + self.cooldown_s
                m.set_gauge("autopilot.stt_target_replicas",
                            float(self.stt_target))
        if len(tier.replicas) != self.stt_target:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, tier.resize, self.stt_target)

    # -------------------------------------------------------- prefill pool

    async def _tick_prefill(self) -> None:
        """The disaggregated prefill pool rides the same band
        controller on its own streaks. Signal = max(mean member pressure,
        live export-queue depth per servable member / 2) — the queue is
        what the decode pool's warm admissions stall behind, and it is
        router-local state, so this band never starves when the
        timeseries plane does. The pool only shrinks to one member (a
        disaggregated fleet with an empty pool silently degrades every
        long admission to a decode-side barrier prefill), and an empty
        pool is the operator's choice — the controller never conjures
        one from nothing."""
        router = self.router
        if not getattr(router, "disagg", False):
            return
        pool = [r for r in router.replicas if r.role == "prefill"]
        if not pool:
            return
        servable = [r for r in pool if r.servable()]
        m = get_metrics()
        meanp = (sum(r.pressure for r in servable) / len(servable)) \
            if servable else 0.0
        depth = getattr(router, "_disagg_inflight", 0)
        qsig = depth / (2.0 * max(1, len(servable)))
        sig = max(meanp, min(1.0, qsig))
        if sig >= self.target_util:
            self._prefill_up_streak += 1
            self._prefill_down_streak = 0
        elif sig < self.target_util / 2:
            self._prefill_down_streak += 1
            self._prefill_up_streak = 0
        else:
            self._prefill_up_streak = self._prefill_down_streak = 0
        want_up = (self._prefill_up_streak >= self.up_windows
                   and self.prefill_target < self.max)
        want_down = (self._prefill_down_streak >= self.down_windows
                     and self.prefill_target > 1)
        if want_up or want_down:
            now = time.monotonic()
            if now < self._prefill_cooldown_until:
                m.inc("autopilot.cooldown_blocks")
                self._record("prefill", "hold", "cooldown", signal=sig,
                             target=self.prefill_target, actual=len(pool))
            else:
                self.prefill_target += 1 if want_up else -1
                m.inc("autopilot.scale_ups" if want_up
                      else "autopilot.scale_downs")
                self._record("prefill",
                             "scale_up" if want_up else "scale_down",
                             "queue" if want_up else "underutilized",
                             signal=sig, target=self.prefill_target,
                             actual=len(pool))
                self._prefill_up_streak = self._prefill_down_streak = 0
                self._prefill_cooldown_until = now + self.cooldown_s
                m.set_gauge("autopilot.prefill_target_replicas",
                            float(self.prefill_target))
        ups = [r for r in pool if r.state == "up"]
        if len(ups) < self.prefill_target:
            await self._join_prefill()
        elif len(ups) > self.prefill_target:
            # cheapest exit: idlest member, newest first — no sessions to
            # ship (nothing ever sticks to a prefill member); the shared
            # retirement pipeline completes at inflight == 0
            victim = min(ups, key=lambda r: (r.inflight, -r.idx))
            if router.start_drain(victim):
                self._retiring.add(victim.url)
                self._record("prefill", "drain", "scale_down",
                             target=self.prefill_target, actual=len(ups),
                             replica=victim.url)
                router._maybe_finish_drain(victim)

    async def _join_prefill(self) -> None:
        """Prefill scale-up: spawn (role-aware when the spawner supports
        it), tag, admit — no joining/pre-warm pipeline, because a prefill
        member holds no sessions and its whole job IS cold prefills:
        admitting it cold is admitting it ready."""
        router = self.router
        try:
            try:
                url = await self.spawner.spawn(role="prefill")
            except TypeError:
                # a role-blind spawner (the duck-typed contract's floor)
                url = await self.spawner.spawn()
        except Exception:
            self._record("prefill", "join_aborted", "spawn_failed",
                         target=self.prefill_target,
                         actual=sum(1 for r in router.replicas
                                    if r.role == "prefill"))
            return
        try:
            member = router.add_member(url)
        except ValueError:
            await self._spawner_retire(url)
            return
        member.role = "prefill"
        self._record("prefill", "join", "ready",
                     target=self.prefill_target,
                     actual=sum(1 for r in router.replicas
                                if r.role == "prefill" and r.state == "up"),
                     replica=member.url)

    # --------------------------------------------------------------- tick

    async def tick_once(self) -> dict:
        """One full control-loop pass: measure -> forecast -> decide ->
        reconcile (brain), then the STT band. Returns ``describe()`` so
        callers driving the loop by hand see the post-tick state."""
        busy, fresh = await self._read_load()
        m = get_metrics()
        if fresh == 0:
            # starved: the controller is blind. Hold the target in BOTH
            # directions; retirements already in flight still complete
            # (finishing a drain needs no fresh signal).
            m.inc("autopilot.holds_starved")
            self._record("brain", "hold", "starved", target=self.target,
                         actual=self._actual())
            await self._finish_retirements()
            await self._tick_prefill()
            await self._tick_stt()
            return self.describe()
        now = time.monotonic()
        self._history.append((now, busy))
        # keep ~8 forecast leads of history: enough for a stable slope,
        # short enough that a finished ramp ages out quickly
        horizon = now - 8 * max(self.forecast_lead_s, self.interval_s)
        self._history = [(t, b) for t, b in self._history if t >= horizon]
        forecast = max(0.0, busy + self._slope() * self.forecast_lead_s)
        self._last_busy, self._last_forecast = busy, forecast
        m.set_gauge("autopilot.load", round(busy, 4))
        m.set_gauge("autopilot.forecast_load", round(forecast, 4))
        demand = max(busy, forecast)
        desired = int(math.ceil(demand / max(self.target_util, 1e-6))) \
            if demand > 1e-9 else self.min
        ups = [r for r in self._brain_members() if r.state == "up"]
        shed = self.router.shed_pressure
        if ups and shed is not None:
            meanp = sum(r.pressure for r in ups) / len(ups)
            if meanp >= shed:
                # emergency override: the fleet is saturated NOW —
                # whatever the forecast says, one more than actual
                desired = max(desired, len(ups) + 1)
        desired = max(self.min, min(self.max, desired))
        self._decide(desired, busy, forecast)
        await self._reconcile()
        await self._tick_prefill()
        await self._tick_stt()
        return self.describe()

    # ------------------------------------------------------------ surface

    def describe(self) -> dict:
        router = self.router
        brain = self._brain_members()
        up = sum(1 for r in brain if r.state == "up")
        joining = sum(1 for r in brain if r.state == "joining")
        draining = sum(1 for r in brain
                       if r.state in ("draining", "drained"))
        out = {
            "enabled": True,
            "brain": {
                "target": self.target, "actual": up, "joining": joining,
                "draining": draining, "retiring": sorted(self._retiring),
                "min": self.min, "max": self.max,
                "load": round(self._last_busy, 4),
                "forecast": round(self._last_forecast, 4),
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "cooldown_remaining_s": round(
                    max(0.0, self._cooldown_until - time.monotonic()), 3),
            },
            "stt": None,
            "decisions": self.decisions[-16:],
        }
        if getattr(router, "disagg", False):
            pool = [r for r in router.replicas if r.role == "prefill"]
            out["prefill"] = {
                "target": self.prefill_target,
                "actual": sum(1 for r in pool if r.state == "up"),
                "servable": sum(1 for r in pool if r.servable()),
                "queue_depth": getattr(router, "_disagg_inflight", 0),
                "up_streak": self._prefill_up_streak,
                "down_streak": self._prefill_down_streak,
                "cooldown_remaining_s": round(
                    max(0.0, self._prefill_cooldown_until
                        - time.monotonic()), 3),
            }
        if self.stt_tier is not None:
            tier = self.stt_tier
            out["stt"] = {
                "target": self.stt_target,
                "actual": len(tier.replicas),
                "healthy": sum(1 for r in tier.replicas if r.servable()),
                "min": self.min, "max": self.max,
                "up_streak": self._stt_up_streak,
                "down_streak": self._stt_down_streak,
                "cooldown_remaining_s": round(
                    max(0.0, self._stt_cooldown_until - time.monotonic()), 3),
            }
        return out
