"""The replica-set core: the ring state machine of both fault tiers.

Port of ``tpu_voice_agent/services/replicaset.py``, pure host code. The
router (``services/router.py``) and the replicated STT tier
(``serve/stt_replicas.py``) run this one core:

- ``Replica``: one member's state (up | joining | draining | drained |
  down) with a passive ``CircuitBreaker`` overlay, probe-failure counting,
  the serve-layer drain latch, a ``pressure`` reading (0..1) and the fleet
  detector's gray state.
- ``ReplicaSet``: placement (rendezvous over the admitting set, sticky
  residence, an LRU session table, forced-move accounting), elastic
  membership (``add_member`` builds a brand-new member, ``joining`` until
  its controller admits it; ``remove_member``), the drain state machine,
  ``apply_probe`` (eject / rejoin / drain latch) and ``apply_fleet_window``
  (peer-relative gray detection over the members' time-series signals).
- ``rendezvous_weight`` hashes with blake2b exactly as JAX does, so a JAX
  router and the port's place a session on the same home.

New sessions avoid members at or over ``shed_pressure`` and gray members
while any member is clear of both; all-over falls back to plain rendezvous.
Sticky sessions never move for pressure or gray. Metric accounting stays in
the tiers: the core calls the ``_on_*`` hooks and each tier names its own
counters (``router.*`` / ``stt.replica*``).

Everything here is synchronous: the router calls it from await-free
sections of its one event loop, the STT tier under its route lock or from
its one watchdog thread.
"""

from __future__ import annotations

import hashlib
import logging
import statistics
import time
from collections import OrderedDict

from .resilience import CircuitBreaker

# --------------------------------------------------- fleet gray detection
#
# The probe/eject machinery above this line catches replicas
# that are DEAD (failed probes, tripped breakers); nothing caught replicas
# that are merely WRONG — slow, recompiling, KV-thrashing — while still
# answering probes "ok". The fleet detector compares each member against
# its PEERS on time-resolved signals read from the members' time-series
# rings (utils.timeseries, scraped by the owning prober): a replica whose
# signal sits a sustained median-absolute-deviation multiple away from the
# fleet median is *gray* — demoted for NEW placements through the same
# avoidance path pressure shedding uses, never ejected (its sticky
# sessions keep their warm state; a wrong eject of a healthy replica
# under fleet-wide load would be worse than the gray replica itself).
#
# Each signal names: how to read it out of one time-series sample, which
# direction is "worse", and an absolute deviation floor — the MAD of a
# tightly clustered fleet approaches 0, and without a floor a 2 ms
# deviation on a 1 ms spread would read as a 2-sigma outlier.
#
#   (signal, kind, metric key, worse-direction, deviation floor)
FLEET_SIGNALS: tuple[tuple[str, str, str, str, float], ...] = (
    # ROUTER-observed per-replica forward wall (kind "observed": measured
    # by the prober's own clock around each /parse forward, injected into
    # the readings rather than read from the member's ring). This is the
    # signal a gray replica cannot hide from: slowness in its network
    # path, middleware, or GC never shows up in its self-reported spans,
    # but the router's stopwatch sees all of it.
    ("fwd_ms", "observed", "router.forward", "high", 25.0),
    # per-replica parse wall this window (tracer-local histogram — stays
    # per-replica even when an in-process harness shares one global
    # registry across replicas); self-reported, so it catches compute-side
    # degradation (recompiles, thrash) with finer attribution than fwd_ms
    ("parse_ms", "hist", "brain.parse", "high", 5.0),
    # the rolling SLO tail (gauge; per-process in real deployments)
    ("parse_p99_ms", "gauge", "slo.brain.p99_ms", "high", 10.0),
    # engine.step decode wall this window — the device-plane symptom of
    # recompiles / jit-cache thrash (step ledger histogram)
    ("decode_ms", "hist", "engine.step.decode", "high", 2.0),
    # speculation health: a replica whose drafts stopped landing decodes
    # token-by-token while its peers emit multiples per forward
    ("tokens_per_forward", "gauge", "scheduler.tokens_per_forward", "low", 0.25),
    # KV pool pressure: one replica evict-thrashing while peers are half
    # empty is a placement pathology, not fleet load
    ("kv_utilization", "gauge", "paged.kv_utilization", "high", 0.05),
    # fault-containment churn: quarantines / prefill-fence trips per sec
    ("quarantine_rate", "rate", "scheduler.slots_quarantined", "high", 0.2),
    ("poison_rate", "rate", "scheduler.prefill_faults", "high", 0.2),
    # quality observatory: a replica that is FAST BUT WRONG —
    # golden-replay canary accuracy and the windowed intent margin are
    # per-replica gauges off the same timeseries rings, so a degraded
    # parser (downgrade storm, drifting quantized tier) is demoted exactly
    # like a slow one. Low direction: smaller is worse.
    ("golden_accuracy", "gauge", "quality.golden_accuracy", "low", 0.05),
    ("intent_margin", "gauge", "quality.intent_margin", "low", 0.25),
)


def signal_values(sample: dict) -> dict[str, float]:
    """One time-series sample -> {signal: value} for every FLEET_SIGNAL
    present in it.
    "observed" signals are the prober's own measurements and never come
    from a member's sample."""
    out: dict[str, float] = {}
    for name, kind, key, _worse, _floor in FLEET_SIGNALS:
        if kind == "gauge":
            v = sample.get("gauges", {}).get(key)
        elif kind == "rate":
            v = sample.get("rates", {}).get(key)
        elif kind == "hist":  # hist window mean
            h = sample.get("hist", {}).get(key)
            v = h.get("ms_per") if isinstance(h, dict) else None
        else:  # "observed": injected by the prober, not sampled
            continue
        if isinstance(v, (int, float)):
            out[name] = float(v)
    return out


def reduce_window(samples: list[dict]) -> dict[str, float]:
    """A scrape window's new samples -> one signal vector (mean per
    signal over the samples that carry it)."""
    acc: dict[str, list[float]] = {}
    for s in samples:
        for name, v in signal_values(s).items():
            acc.setdefault(name, []).append(v)
    return {name: sum(xs) / len(xs) for name, xs in acc.items()}


def fleet_outlier_scores(readings: dict[str, dict[str, float]],
                         min_peers: int = 3) -> tuple[dict, dict]:
    """Peer-relative outlier scores for one scrape window.

    ``readings`` maps member key -> signal vector. Per signal, members
    reporting it form the peer pool; with fewer than ``min_peers`` the
    signal is skipped (a median of two cannot say WHICH one is wrong).
    Score = worse-direction deviation from the fleet median, scaled by
    max(MAD, floor). A member's score is its worst signal's.

    Returns ``(scores, aggregates)``: scores maps member ->
    {score, signal, value, median, mad}; aggregates maps signal ->
    {median, mad, min, max, n} (the fleet roll-up /health carries).
    """
    per_signal: dict[str, dict[str, float]] = {}
    for member, sig in readings.items():
        for name, v in sig.items():
            per_signal.setdefault(name, {})[member] = v
    aggregates: dict[str, dict] = {}
    scores: dict[str, dict] = {m: {"score": 0.0, "signal": None,
                                   "value": None, "median": None, "mad": None}
                               for m in readings}
    floors = {name: floor for name, _k, _key, _w, floor in FLEET_SIGNALS}
    worse = {name: w for name, _k, _key, w, _f in FLEET_SIGNALS}
    for name, by_member in per_signal.items():
        xs = list(by_member.values())
        if len(xs) < min_peers:
            continue
        med = statistics.median(xs)
        mad = statistics.median(abs(x - med) for x in xs)
        scale = max(mad, floors.get(name, 1e-9), 1e-9)
        aggregates[name] = {"median": round(med, 4), "mad": round(mad, 4),
                            "min": round(min(xs), 4), "max": round(max(xs), 4),
                            "n": len(xs)}
        for member, x in by_member.items():
            dev = (x - med) if worse.get(name, "high") == "high" else (med - x)
            score = max(0.0, dev) / scale
            if score > scores[member]["score"]:
                scores[member] = {"score": round(score, 3), "signal": name,
                                  "value": round(x, 4),
                                  "median": round(med, 4),
                                  "mad": round(mad, 4)}
    return scores, aggregates


def rendezvous_weight(key: str, session_id: str) -> int:
    """Rendezvous (highest-random-weight) score: deterministic per
    (replica, session) pair, so removing a replica re-homes ONLY its own
    sessions — each to its next-highest-weight choice."""
    digest = hashlib.blake2b(f"{key}|{session_id}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


class Replica:
    """One ring member's routing state. ``state`` is the administrative
    machine (up | joining | draining | drained | down); the breaker
    overlays transport health on top of it without changing it. ``url``
    is the member's ring key — a base URL for HTTP tiers, a name for
    in-process ones (the STT batcher ring). ``joining`` is a
    member the autopilot spawned but has not pre-warmed/admitted yet:
    not admitting, not servable, invisible to the probe state machine."""

    __slots__ = ("idx", "url", "state", "breaker", "probe_fails",
                 "inflight", "last_health", "drain_latched", "pressure",
                 "gray", "gray_streak", "ok_streak", "outlier_score",
                 "outlier_signal", "gray_evidence", "gray_held_since",
                 "signals", "signal_ages", "fwd_acc", "ts_seq",
                 "clock_skew_s", "role")

    def __init__(self, idx: int, url: str, breaker_threshold: int,
                 breaker_reset_s: float):
        self.idx = idx
        self.url = url.rstrip("/")
        self.state = "up"
        # passive failure counting through the breaker: a replica that
        # hangs on /parse while answering /health probes still leaves the
        # ring after breaker_threshold consecutive transport failures, and
        # the half-open window re-discovers it without operator action
        self.breaker = CircuitBreaker(
            f"replica{idx}", failure_threshold=breaker_threshold,
            reset_after_s=breaker_reset_s)
        self.probe_fails = 0
        self.inflight = 0
        self.last_health: dict | None = None
        # set when a probe has SEEN the replica's serve-layer drain latch
        # in /health while draining/drained; its later disappearance is the
        # evidence of a completed restart (fresh process, latch gone)
        self.drain_latched = False
        # saturation fraction in [0, 1] reported by the member (brain
        # /health ``pressure.score``; STT queue depth / cap) — the shed
        # signal placement reads BEFORE admission controllers refuse
        self.pressure = 0.0
        # fleet gray-failure state: gray = peer-relative
        # outlier sustained FLEET_GRAY_WINDOWS scrape windows — demoted
        # for new placements, never ejected; sticky sessions stay.
        self.gray = False
        self.gray_streak = 0
        self.ok_streak = 0
        self.outlier_score = 0.0
        self.outlier_signal: str | None = None
        self.gray_evidence: dict | None = None
        # wall time when the gray verdict last went evidence-starved (no
        # scoreable reading on the demoting signal); None while evidence
        # flows — the gray-hold expiry clock
        self.gray_held_since: float | None = None
        # last known value + carried-window age PER SIGNAL (a slow
        # replica produces SPARSE samples — exactly the member the
        # detector must not lose sight of between windows; and the
        # always-fresh gauge signals must never stomp a carried sparse
        # one, so carry is per signal, not per vector)
        self.signals: dict[str, float] = {}
        self.signal_ages: dict[str, int] = {}
        # router-observed forward walls (ms) accumulated since the last
        # fleet window — the "observed" fwd_ms signal's raw material
        self.fwd_acc: list[float] = []
        # time-series delta cursor + estimated wall-clock skew vs the
        # prober (NTP-style midpoint estimate, recorded per scrape so
        # multi-service flight dumps can be merged on one clock)
        self.ts_seq = 0
        self.clock_skew_s = 0.0
        # serving role (disaggregation): "both" serves any
        # traffic; "prefill" members run long cold prefills and stream the
        # KV out, so the router keeps STICKY sessions off them; "decode"
        # is documentation-only today (a decode member behaves like
        # "both"). Set by the owning tier from a `url#role` key tag or a
        # probe body's self-reported role — the ring core never parses.
        self.role = "both"

    def admitting(self) -> bool:
        """May receive NEW sessions (and anonymous parses)."""
        return self.state == "up" and self.breaker.state != "open"

    def servable(self) -> bool:
        """May keep serving its EXISTING sessions (draining replicas
        finish their own sessions' turns until ejected)."""
        return self.state in ("up", "draining") and self.breaker.state != "open"

    def describe(self) -> dict:
        out = {"url": self.url, "state": self.state,
               "breaker": self.breaker.state, "inflight": self.inflight,
               "probe_fails": self.probe_fails,
               "pressure": round(self.pressure, 4),
               "gray": self.gray,
               "outlier_score": round(self.outlier_score, 3),
               "clock_skew_s": round(self.clock_skew_s, 4)}
        if self.outlier_signal:
            out["outlier_signal"] = self.outlier_signal
        if self.role != "both":
            out["role"] = self.role
        return out


class ReplicaSet:
    """Ring state + placement; tiers subclass it and implement the metric
    hooks with their own literal counter names.

    Every mutation of routing state happens inside one call (no internal
    waits), so an event-loop tier keeps its await-free critical sections
    and a threaded tier serializes calls on its own one watchdog/submit
    discipline.
    """

    def __init__(self, keys: list[str], *,
                 probe_fails_limit: int = 2,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 2.0,
                 max_sessions: int = 4096,
                 shed_pressure: float | None = None,
                 gray_mad: float | None = None,
                 gray_windows: int = 3,
                 gray_min_peers: int = 3,
                 gray_hold_s: float = 300.0,
                 log_name: str = "tpu_voice_agent_torch.replicaset"):
        if not keys:
            raise ValueError("a replica set needs at least one member")
        self.probe_fails_limit = probe_fails_limit
        self.max_sessions = max_sessions
        self.shed_pressure = shed_pressure
        # gray-failure detection: None disables it; the owning
        # prober feeds apply_fleet_window with per-member signal vectors
        self.gray_mad = gray_mad
        self.gray_windows = max(1, gray_windows)
        self.gray_min_peers = max(2, gray_min_peers)
        self.gray_hold_s = gray_hold_s
        self.last_fleet: dict | None = None
        # roles placement must avoid: the disaggregating router
        # sets {"prefill"} so general traffic lands only on decode-capable
        # members. Empty (the default) keeps _pick byte-identical to the
        # pre-disagg build. Like pressure/gray avoidance, an empty filtered
        # pool falls back to the whole admitting set: a fleet that is ALL
        # prefill-tagged still serves, it never errors here.
        self.exclude_roles: set[str] = set()
        # kept for elastic membership: add_member builds every
        # later Replica with the same breaker discipline the seed got
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.replicas = [Replica(i, k, breaker_threshold, breaker_reset_s)
                         for i, k in enumerate(keys)]
        # idx is a member's PERMANENT identity (per-idx gauges, batcher
        # keys): monotonic, never reused — a respawned member at the same
        # url is a NEW member with a new idx and fresh state
        self._next_idx = len(self.replicas)
        self._by_url = {r.url: r for r in self.replicas}
        # session -> home-replica key, LRU-capped; stickiness (drain, no
        # flap-back on recovery) and the re-home accounting both live here
        self._sessions: "OrderedDict[str, str]" = OrderedDict()
        self._log = logging.getLogger(log_name)

    # ------------------------------------------------------- metric hooks
    # Each tier overrides these with its own literal metric names.

    def _on_rehome(self) -> None: ...

    def _on_shed_pressure(self) -> None: ...

    def _on_shed_gray(self) -> None: ...

    def _on_gray_entered(self, replica: Replica, evidence: dict) -> None: ...

    def _on_gray_cleared(self, replica: Replica) -> None: ...

    def _update_gray_gauge(self) -> None: ...

    def _on_drain(self) -> None: ...

    def _on_drain_completed(self) -> None: ...

    def _on_member_added(self, replica: Replica) -> None: ...

    def _on_member_removed(self, replica: Replica) -> None: ...

    def _on_ejected(self, replica: Replica) -> None: ...

    def _on_recovered(self, replica: Replica) -> None: ...

    def _update_health_gauge(self) -> None: ...

    # ------------------------------------------------------------ routing

    def _pick(self, session_id: str | None, exclude=(),
              count: bool = False) -> Replica | None:
        """Pure placement (no session-table update): rendezvous over the
        admitting set for keyed sessions, least-inflight for anonymous
        parses. The hedging path uses this so a hedge never re-homes.

        With ``shed_pressure`` armed, members at/over the threshold are
        avoided for new placements while at least one member is under it;
        ``gray`` members (fleet-detected peer-relative outliers)
        are avoided through the SAME path — demotion, never an eject —
        and all-over falls back to the full set: overload or a gray-swept
        fleet degrades placement quality, it never turns into an error.
        ``count=True`` fires ``_on_shed_pressure`` / ``_on_shed_gray``
        when the avoidance actually changed the keyed choice — only
        ``route_ex``'s real placements pass it, so a hedge probing
        alternatives never inflates the shed counters."""
        cands = [r for r in self.replicas
                 if r.admitting() and r.url not in exclude]
        if not cands:
            return None
        if self.exclude_roles:
            # role filter: excluded-role members leave the
            # placement UNIVERSE (not just the preference pool) so a
            # prefill member never becomes a rendezvous "top" choice that
            # inflates shed counters — unless filtering would empty the
            # ring, in which case every member serves (degraded placement
            # beats an error, same contract as all-over pressure).
            keep = [r for r in cands if r.role not in self.exclude_roles]
            if keep:
                cands = keep
        avoid = {r.url for r in cands if r.gray}
        if self.shed_pressure is not None:
            avoid |= {r.url for r in cands if r.pressure >= self.shed_pressure}
        pool = [r for r in cands if r.url not in avoid]
        if not pool or len(pool) == len(cands):
            pool = cands
        if session_id:
            top = max(cands, key=lambda r: rendezvous_weight(r.url, session_id))
            if pool is cands:
                return top
            best = max(pool, key=lambda r: rendezvous_weight(r.url, session_id))
            if count and best is not top:
                if top.gray:
                    self._on_shed_gray()
                else:
                    self._on_shed_pressure()
            return best
        return min(pool, key=lambda r: r.inflight)

    def route_ex(self, session_id: str | None,
                 exclude=()) -> tuple[Replica | None, str | None]:
        """The authoritative per-request decision: sticky home while it is
        servable, else rendezvous placement over the admitting set (which
        IS the deterministic next-highest-weight re-home when the old home
        left the ring). Returns ``(home, rehomed_from)`` — the second
        element is the PREVIOUS home's key exactly when this call forced a
        move (the caller decides whether warm state can be shipped from
        there). Counts every forced move via ``_on_rehome``."""
        # atomic-section: replicaset.route -- session-table read+mutate must be one event-loop step: an await between the sticky lookup and the re-home write lets a racing request route the same session elsewhere
        rehomed_from: str | None = None
        if session_id:
            prev_url = self._sessions.get(session_id)
            if prev_url is not None and prev_url not in exclude:
                prev = self._by_url.get(prev_url)
                if prev is not None and prev.servable():
                    self._sessions.move_to_end(session_id)
                    return prev, None
        home = self._pick(session_id, exclude, count=True)
        if home is None:
            return None, None
        if session_id:
            prev_url = self._sessions.get(session_id)
            if prev_url is not None and prev_url != home.url:
                rehomed_from = prev_url
                self._on_rehome()
            self._sessions[session_id] = home.url
            self._sessions.move_to_end(session_id)
            while len(self._sessions) > self.max_sessions:
                self._sessions.popitem(last=False)
        # end-atomic-section
        return home, rehomed_from

    def route(self, session_id: str | None, exclude=()) -> Replica | None:
        return self.route_ex(session_id, exclude)[0]

    def forget_session(self, session_id: str) -> None:
        """Drop a closed session's sticky entry (the STT tier's utterance
        keys rotate per utterance — without this the LRU churns)."""
        self._sessions.pop(session_id, None)

    # ----------------------------------------------- elastic membership

    def add_member(self, key: str, *, joining: bool = False) -> Replica:
        """Grow the ring by one BRAND-NEW member. Always a
        fresh ``Replica`` — a controller respawning a member at a reused
        key must get clean gray/outlier/pressure state, because every
        carried verdict described the process that died. ``joining=True``
        parks it outside placement until the owning controller pre-warms
        and admits it."""
        # atomic-section: replicaset.member-add -- ring list, url index and the health gauge must grow as one step: a suspension mid-add lets route() see a member the gauges (and _by_url) do not
        key = key.rstrip("/")
        if key in self._by_url:
            raise ValueError(f"replica key {key!r} already in the ring")
        r = Replica(self._next_idx, key, self.breaker_threshold,
                    self.breaker_reset_s)
        self._next_idx += 1
        if joining:
            r.state = "joining"
        self.replicas.append(r)
        self._by_url[r.url] = r
        self._on_member_added(r)
        self._update_health_gauge()
        # end-atomic-section
        self._log.info("replica %s added to the ring (%s)", r.url, r.state)
        return r

    def remove_member(self, key: str) -> Replica | None:
        """Retire a member out of the ring. Its sticky sessions stay in
        the table and re-home LAZILY: the next ``route_ex`` finds the old
        home gone, picks the next-highest-weight member, and counts the
        forced move — exactly the crash re-home path, so removal never
        invents a second accounting. Returns the removed member (its
        object stays valid for the caller's retirement bookkeeping) or
        None when the key is not in the ring."""
        # atomic-section: replicaset.member-remove -- ring list, url index and the gauges must shrink as one step: route() must never pick a member whose index entry is already gone
        r = self._by_url.pop(key.rstrip("/"), None)
        if r is None:
            return None
        self.replicas.remove(r)
        self._on_member_removed(r)
        self._update_health_gauge()
        self._update_gray_gauge()
        # end-atomic-section
        self._log.info("replica %s removed from the ring", r.url)
        return r

    # -------------------------------------------------- fleet gray state

    def _reset_gray(self, r: Replica) -> None:
        """A restarted/readmitted member starts with a clean slate — its
        gray verdict described the OLD process. The PRESSURE carry-forward
        resets here too: pressure rides health probes, so a
        fresh process inherits the dead one's last saturation reading
        until its first probe lands — long enough for the shed path to
        steer new sessions away from exactly the capacity a respawn just
        added."""
        if r.gray:
            r.gray = False
            self._on_gray_cleared(r)
        r.pressure = 0.0
        r.gray_streak = 0
        r.ok_streak = 0
        r.outlier_score = 0.0
        r.outlier_signal = None
        r.gray_evidence = None
        r.gray_held_since = None
        r.signals = {}
        r.signal_ages = {}
        r.fwd_acc = []
        r.ts_seq = 0
        self._update_gray_gauge()

    def apply_fleet_window(self, readings: dict[str, dict[str, float]]) -> dict:
        """One scrape window's verdict: fold fresh per-member signal
        vectors in, score every member against its peers (MAD over the
        ring, ``fleet_outlier_scores``), advance the gray streaks, and
        flip the gray state symmetrically — ``gray_windows`` consecutive
        outlier windows enter, the same count of clean windows clear.

        Carry-forward is PER SIGNAL: a sparse signal (a slow replica's
        parse wall lands only when a parse completes — exactly the member
        the detector must not lose between windows) is carried for up to
        ``gray_windows`` windows while the always-fresh gauge signals
        update around it; past that it ages out of the member's vector.
        Detection is a no-op while fewer than ``gray_min_peers`` members
        report a signal — a median of two cannot say which one is wrong.
        A GRAY member's recovery additionally requires live evidence on
        the signal that demoted it: absence of data holds the verdict,
        only measured health clears it.
        """
        # atomic-section: replicaset.fleet-window -- streak advancement and the gray flip must commit as one step: a suspension mid-window lets route() observe a half-applied verdict (score updated, gray flag stale)
        if self.gray_mad is None:
            return {}
        pool: dict[str, dict[str, float]] = {}
        for r in self.replicas:
            fresh = readings.get(r.url) or {}
            for name, v in fresh.items():
                r.signals[name] = v
                r.signal_ages[name] = 0
            for name in list(r.signals):
                if name not in fresh:
                    r.signal_ages[name] = r.signal_ages.get(name, 0) + 1
                    if r.signal_ages[name] > self.gray_windows:
                        del r.signals[name]
                        del r.signal_ages[name]
            if r.signals and r.servable():
                pool[r.url] = dict(r.signals)
        scores, aggregates = fleet_outlier_scores(
            pool, min_peers=self.gray_min_peers)
        entered: list[str] = []
        cleared: list[str] = []
        for r in self.replicas:
            verdict = scores.get(r.url)
            if verdict is None:
                continue  # no data this window: streaks hold
            if r.gray and r.gray_evidence:
                ev_sig = r.gray_evidence["signal"]
                if ev_sig not in (pool.get(r.url) or {}) \
                        or ev_sig not in aggregates:
                    # the signal that demoted it was not SCORED this
                    # window (no live reading from the member, or too few
                    # peers reporting it): the verdict holds — recovery
                    # needs measured health, not silence. But demotion
                    # itself starves a traffic-borne signal like fwd_ms
                    # (no new sessions ⇒ no forwards ⇒ no reading), so an
                    # unbounded hold would strand a RECOVERED replica out
                    # of placement forever: after ``gray_hold_s`` of
                    # sustained starvation the verdict expires and the
                    # replica rejoins — if it is still sick, the first
                    # windows of returning traffic re-demote it.
                    now = time.time()
                    if r.gray_held_since is None:
                        r.gray_held_since = now
                    elif now - r.gray_held_since >= self.gray_hold_s:
                        r.gray = False
                        r.gray_evidence = None
                        r.gray_held_since = None
                        r.gray_streak = 0
                        r.ok_streak = 0
                        cleared.append(r.url)
                        self._log.info(
                            "replica %s gray verdict expired after %.0fs "
                            "without scoreable evidence on %s", r.url,
                            self.gray_hold_s, ev_sig)
                        self._on_gray_cleared(r)
                        self._update_gray_gauge()
                    continue
                r.gray_held_since = None  # evidence flows again
            r.outlier_score = verdict["score"]
            r.outlier_signal = verdict["signal"]
            if verdict["score"] >= self.gray_mad:
                r.gray_streak += 1
                r.ok_streak = 0
            else:
                r.ok_streak += 1
                r.gray_streak = 0
            if not r.gray and r.gray_streak >= self.gray_windows:
                r.gray = True
                r.gray_held_since = None
                r.gray_evidence = {
                    "replica": r.url,
                    "signal": verdict["signal"],
                    "value": verdict["value"],
                    "fleet_median": verdict["median"],
                    "mad": verdict["mad"],
                    "score": verdict["score"],
                    "threshold": self.gray_mad,
                    "windows": r.gray_streak,
                    "peers": {u: {k: round(v, 4) for k, v in sig.items()}
                              for u, sig in pool.items()},
                    "aggregates": aggregates,
                    "clock_skew_s": {x.url: round(x.clock_skew_s, 4)
                                     for x in self.replicas},
                }
                entered.append(r.url)
                self._log.warning(
                    "replica %s marked GRAY: %s=%s vs fleet median %s "
                    "(score %.1f x MAD >= %.1f for %d windows)",
                    r.url, verdict["signal"], verdict["value"],
                    verdict["median"], verdict["score"], self.gray_mad,
                    r.gray_streak)
                # gauge BEFORE the hook: the hook freezes the flight
                # recorder, and the dump's final snapshot should show the
                # fleet state the freeze is about
                self._update_gray_gauge()
                self._on_gray_entered(r, r.gray_evidence)
            elif r.gray and r.ok_streak >= self.gray_windows:
                r.gray = False
                r.gray_evidence = None
                r.gray_held_since = None
                cleared.append(r.url)
                self._log.info("replica %s recovered from gray", r.url)
                self._on_gray_cleared(r)
        self._update_gray_gauge()
        self.last_fleet = {"scores": scores, "aggregates": aggregates,
                           "gray": [r.url for r in self.replicas if r.gray],
                           "entered": entered, "cleared": cleared}
        # end-atomic-section
        return self.last_fleet

    # ------------------------------------------------------------- drain

    # atomic-section: replicaset.ring-state -- replica state transitions (up/draining/drained) and the health gauge must commit atomically: a suspension mid-transition exposes a half-drained ring to concurrent route() calls
    def start_drain(self, replica: Replica) -> bool:
        """Stop placing new sessions on ``replica``; existing sessions keep
        hitting it until in-flight reaches zero, then it is ejected. A
        JOINING member drains too: a manual drain must always
        win the race against the autopilot's concurrent scale-up of that
        slot — the controller's admit checks the state is still
        ``joining`` and aborts the join when it is not."""
        if replica.state not in ("up", "joining"):
            return False
        replica.state = "draining"
        replica.drain_latched = False  # fresh drain cycle
        self._on_drain()
        self._update_health_gauge()
        self._maybe_finish_drain(replica)
        return True

    def _maybe_finish_drain(self, replica: Replica) -> None:
        if replica.state == "draining" and replica.inflight == 0:
            replica.state = "drained"
            self._on_drain_completed()
            self._update_health_gauge()

    def admit(self, replica: Replica) -> None:
        replica.state = "up"
        replica.probe_fails = 0
        replica.drain_latched = False
        self._reset_gray(replica)
        self._update_health_gauge()
    # end-atomic-section

    # ------------------------------------------------------------ probing

    def apply_probe(self, r: Replica, ok: bool, body: dict | None) -> None:
        """One probe's verdict: the eject/rejoin/drain-latch state machine.
        The caller owns the transport (HTTP GET, thread-liveness check) and hands the
        result here; ``body`` is the member's health body when one exists."""
        # atomic-section: replicaset.probe-verdict -- the eject/rejoin/drain-latch state machine must not suspend mid-way: route() must never observe a replica between two of these transitions
        body = body if isinstance(body, dict) else {}
        if r.state == "joining":
            # a JOINING member is the controller's alone:
            # probes record its health body but never promote OR eject it
            # — an ok probe proves alive, not pre-warmed (auto-admitting
            # here would admit it cold), and a failing pre-warm is the
            # join timeout's verdict to make, not the prober's (an eject
            # to "down" here would let the NEXT ok probe auto-admit it
            # cold through the recovery path).
            if ok and body:
                r.last_health = body
            return
        if ok:
            r.probe_fails = 0
            if body:
                r.last_health = body
                # a member's self-reported serving role refines
                # the ring's view — but only an EXPLICIT role lands:
                # "both" is also the BRAIN_ROLE env default, so a member
                # that never set it must not clear a router-side
                # `url#prefill` key tag with its first probe
                role = body.get("role")
                if role in ("prefill", "decode"):
                    r.role = role
            if r.state == "down":
                # recovered (or restarted after a drain): rejoin the ring.
                # Its old sessions stay where they re-homed (stickiness);
                # new sessions flow here again by rendezvous weight. A
                # fresh process also sheds any gray verdict — the outlier
                # evidence described the old one.
                r.state = "up"
                r.drain_latched = False
                self._reset_gray(r)
                self._on_recovered(r)
            elif r.state in ("draining", "drained") and body.get("draining"):
                r.drain_latched = True
            elif r.state == "drained" and r.drain_latched:
                # the rolling restart was faster than probe_fails
                # consecutive probe windows, so the replica never read
                # "down" — but the serve-layer drain latch we saw while it
                # was drained is gone now, and only a FRESH process drops
                # it: rejoin directly from drained. (A replica that never
                # showed the latch stays drained until an explicit admit —
                # the ring-side drain must hold for latch-less replicas.)
                r.state = "up"
                r.drain_latched = False
                self._reset_gray(r)
                self._on_recovered(r)
            elif r.state == "up" and body.get("draining"):
                # drain issued directly at the replica: honor it here too
                self.start_drain(r)
        else:
            r.probe_fails += 1
            if r.probe_fails >= self.probe_fails_limit and r.state != "down":
                r.state = "down"
                self._on_ejected(r)
                self._log.warning(
                    "replica %s ejected after %d failed probes",
                    r.url, r.probe_fails)
        # end-atomic-section

    # ------------------------------------------------------------- health

    def health_counts(self) -> tuple[int, int, int]:
        """(total, healthy-servable, draining) — the /health shape both
        tiers report and both HUD badges render."""
        total = len(self.replicas)
        healthy = sum(1 for r in self.replicas if r.servable())
        draining = sum(1 for r in self.replicas if r.state == "draining")
        return total, healthy, draining
