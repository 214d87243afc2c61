"""The replicated STT tier: N ``STTBatcher`` replicas behind utterance-affine
placement.

Port of ``tpu_voice_agent/serve/stt_replicas.py`` (``STT_BATCH_ENABLE=1``
with ``STT_REPLICAS`` > 1). The replicas share one loaded ``SpeechEngine``
(its weights are read-only); each owns its own cross-KV slot pool and worker
thread. They sit behind the ring core the router runs
(``services.replicaset.ReplicaSet``):

- **Affinity by utterance.** An utterance's partials, spec_finals and final
  hit one replica (its incremental slot lives in that replica's pool);
  ``release`` forgets the sticky entry when the utterance closes.
- **Health = the stalled-tick watchdog.** A thread sweeps every
  ``STT_REPLICA_PROBE_S`` (0.25): a dead worker, the dead latch, or ticks
  frozen for ``STT_REPLICA_STALL_S`` (5) with work pending ejects the
  replica (``apply_probe``) and warm-restarts it: a fresh ``STTBatcher``
  over the same engine, with a pool of its own (``stt.replica_restarts``).
- **Failover.** A re-homed utterance re-anchors on the voice side's
  buffered audio (``stt.replica_rehomed``); a final that fails on its home
  is resubmitted once on the next-best replica (``stt.replica_failovers``):
  a crashed replica costs latency, never a final.
- **Pressure shedding.** The watchdog publishes each replica's queue depth
  over its cap as its pressure; new utterances avoid replicas at or over
  ``STT_SHED_PRESSURE`` (0.9) while any is under it
  (``stt.replica_shed_pressure``).

All replicas launch on the device's current stream: the split kernels'
scratch and ticket counters (``ops/_lib.py``) are per device and serve one
stream at a time, so no worker takes a stream of its own. The tier has
``STTBatcher``'s ``submit`` / ``release``, so ``BatchedStreamingSTT`` takes
it unchanged; ``resize`` grows or shrinks it for the autopilot.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future

from ..services.replicaset import Replica, ReplicaSet
from ..utils.tracing import get_metrics
from .stt_batch import STTBatcher

# the process-global tier: the voice /health handler reads the ring through
# it without threading the object through the STT factory
_TIER: "STTReplicaTier | None" = None


def current_tier() -> "STTReplicaTier | None":
    return _TIER


class STTReplicaTier(ReplicaSet):
    """N ``STTBatcher`` replicas with utterance-affine placement, a
    stalled-tick watchdog that warm-restarts wedged replicas, and final
    failover. ``autostart=False`` builds manually-ticked batchers and no
    watchdog (tests drive ``sweep_once``/``batcher.tick`` themselves)."""

    def __init__(self, engine, replicas: int = 2, slots: int = 4, *,
                 probe_s: float | None = None,
                 stall_s: float | None = None,
                 shed_pressure: float | None = None,
                 max_pending: int | None = None,
                 autostart: bool = True,
                 register: bool = True):
        if replicas < 1:
            raise ValueError("need at least one STT replica")
        env = os.environ.get
        self.probe_s = probe_s if probe_s is not None else \
            float(env("STT_REPLICA_PROBE_S", "0.25"))
        self.stall_s = stall_s if stall_s is not None else \
            float(env("STT_REPLICA_STALL_S", "5.0"))
        super().__init__(
            [f"stt-{i}" for i in range(replicas)],
            probe_fails_limit=2,
            shed_pressure=(shed_pressure if shed_pressure is not None
                           else float(env("STT_SHED_PRESSURE", "0.9"))),
            log_name="tpu_voice_agent_torch.stt_replicas")
        self.engine = engine
        self.slots = slots
        self.max_pending = max_pending
        # unlike the router (whose event loop serializes routing), this
        # tier is hit from the voice event loop AND batcher-worker
        # failover callbacks concurrently — the session table needs a lock
        self._route_lock = threading.Lock()
        self._autostart = autostart
        # keyed by the member's PERMANENT idx, not list position: elastic
        # resize retires members, and idx is never reused
        self.batchers = {r.idx: self._make_batcher() for r in self.replicas}
        # per-replica (last ticks seen, last progress time) for the
        # stalled-tick verdict
        self._seen = {r.idx: (0, time.monotonic()) for r in self.replicas}
        # the contract counters exist from construction (scrape-visible at
        # zero — the breaker-gauge discipline)
        m = get_metrics()
        m.inc("stt.replica_restarts", 0.0)
        m.inc("stt.replica_failovers", 0.0)
        m.inc("stt.replica_rehomed", 0.0)
        m.inc("stt.replica_shed_pressure", 0.0)
        m.inc("stt.replica_ejected", 0.0)
        self._update_health_gauge()
        self._stop_evt = threading.Event()
        self._watchdog: threading.Thread | None = None
        if autostart:
            self._watchdog = threading.Thread(
                target=self._watch, name="stt-replica-watchdog", daemon=True)
            self._watchdog.start()
        if register:
            global _TIER
            _TIER = self

    def _make_batcher(self) -> STTBatcher:
        return STTBatcher(self.engine, slots=self.slots,
                          max_pending=self.max_pending,
                          autostart=self._autostart)

    # ---------------------------------------------- replica-set hooks
    # literal metric names: the shared core routes its accounting here

    def _update_health_gauge(self) -> None:
        m = get_metrics()
        # total rides the hook so elastic resize keeps it honest
        m.set_gauge("stt.replicas_total", float(len(self.replicas)))
        m.set_gauge("stt.replicas_healthy",
                    float(sum(1 for r in self.replicas if r.servable())))

    def _on_rehome(self) -> None:
        get_metrics().inc("stt.replica_rehomed")

    def _on_shed_pressure(self) -> None:
        get_metrics().inc("stt.replica_shed_pressure")

    def _on_ejected(self, replica: Replica) -> None:
        get_metrics().inc("stt.replica_ejected")

    def _on_recovered(self, replica: Replica) -> None: ...

    # ----------------------------------------------------------- watchdog

    def sweep_once(self) -> None:
        """One health sweep: liveness + stalled-tick verdict per replica
        through the shared ``apply_probe`` machine, pressure refresh, and
        the warm restart of anything ejected."""
        now = time.monotonic()
        for r in list(self.replicas):  # resize may mutate concurrently
            b = self.batchers.get(r.idx)
            if b is None:  # retired between the snapshot and this sweep
                continue
            with b._wake:
                ticks, busy, depth = b.ticks, b._busy, len(b.queue)
            r.pressure = depth / max(1, b.max_pending)
            alive = b.healthy()
            stalled = False
            if alive:
                last_ticks, last_t = self._seen[r.idx]
                if ticks != last_ticks or not (busy or depth):
                    self._seen[r.idx] = (ticks, now)
                elif now - last_t >= self.stall_s:
                    stalled = True
            self.apply_probe(r, alive and not stalled, None)
            if r.state == "down" and (not alive or stalled):
                # warm-restart the corpse NOW (a fresh batcher over the
                # same engine); the ring re-admits it on the next sweep's
                # healthy verdict — restart only when THIS sweep saw it
                # bad, so a just-restarted healthy batcher is never churned
                self._restart(r.idx)
        self._update_health_gauge()

    def _restart(self, idx: int) -> None:
        """Warm-restart one replica: retire the old batcher (failing its
        queued/in-flight futures fast so waiters fail over instead of
        timing out) and build a fresh one over the SAME engine — loaded
        Whisper weights are reused, so the restart
        is slot-pool bookkeeping, not a model load."""
        old = self.batchers.get(idx)
        if old is None:  # retired by a concurrent resize: nothing to revive
            return
        old.kill(RuntimeError(
            f"stt replica {idx} warm-restarted (dead or stalled worker)"))
        self.batchers[idx] = self._make_batcher()
        self._seen[idx] = (0, time.monotonic())
        get_metrics().inc("stt.replica_restarts")
        self._log.warning("stt replica %d warm-restarted", idx)

    def _watch(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.sweep_once()
            except Exception:  # pragma: no cover - watchdog must never die
                self._log.exception("stt replica sweep failed")
            self._stop_evt.wait(self.probe_s)

    # ------------------------------------------------------------- submit

    def _route(self, key: str, exclude=()) -> Replica | None:
        with self._route_lock:
            return self.route(key, exclude)

    def _home_for(self, utt: int) -> Replica | None:
        """Route with a dead-latch overlay: a batcher the watchdog has not
        swept out of the ring yet is excluded NOW rather than bouncing
        work off a corpse (the resulting forced move counts
        stt.replica_rehomed via the route hook). Exclusions ACCUMULATE —
        two corpses must not mask a healthy third replica."""
        key = str(utt)
        exclude: set[str] = set()
        while True:
            home = self._route(key, exclude)
            if home is None:
                return None
            b = self.batchers.get(home.idx)
            if b is not None and b.healthy():
                return home
            exclude.add(home.url)

    def submit(self, kind: str, utt: int, buf,
               tenant: str | None = None) -> Future:
        """STTBatcher-compatible submit with utterance affinity. Finals are
        wrapped with a one-shot failover: an exception from the home
        replica (crash, kill drill, restart) resubmits the same window on
        the next-best replica — the audio travels with the work item, so
        the failover is a re-encode, never a loss."""
        home = self._home_for(utt)
        hb = self.batchers.get(home.idx) if home is not None else None
        if hb is None:
            # whole tier out: shed best-effort work, fail finals (the
            # voice handler surfaces a warn; the session itself survives)
            fut: Future = Future()
            if kind == "final":
                fut.set_exception(RuntimeError("no stt replicas available"))
            else:
                get_metrics().inc("stt.shed_overload")
                fut.set_result(None)
            return fut
        inner = hb.submit(kind, utt, buf, tenant=tenant)
        if kind != "final":
            return inner  # best-effort: a lost partial is latency, not data
        outer: Future = Future()

        def _relay(f: Future, failed_key: str, retry: bool) -> None:
            try:
                exc = f.exception()
            except BaseException:  # cancelled upstream: mirror it
                outer.cancel()
                return
            if exc is None:
                try:
                    outer.set_result(f.result())
                except Exception:
                    pass  # raced a caller-side cancel
                return
            if retry:
                alt = self._route(str(utt), exclude={failed_key})
                ab = self.batchers.get(alt.idx) if alt is not None else None
                if ab is not None and ab.healthy():
                    # counted only when a resubmit actually happens — a
                    # whole-tier outage must not read as successful
                    # failovers on the dashboard
                    get_metrics().inc("stt.replica_failovers")
                    f2 = ab.submit(kind, utt, buf, tenant=tenant)
                    f2.add_done_callback(
                        lambda g, k=alt.url: _relay(g, k, retry=False))
                    return
            try:
                outer.set_exception(exc)
            except Exception:
                pass

        inner.add_done_callback(lambda f, k=home.url: _relay(f, k, retry=True))
        return outer

    def release(self, utt: int) -> None:
        """Utterance closed: free its slot wherever it lived (a re-homed
        utterance may have touched several replicas) and drop the sticky
        entry so rotated utterance keys don't churn the LRU."""
        for b in list(self.batchers.values()):
            try:
                b.release(utt)
            except Exception:
                pass
        with self._route_lock:
            self.forget_session(str(utt))

    # -------------------------------------------------------------- admin

    def tier_health(self) -> dict:
        total, healthy, draining = self.health_counts()
        return {"total": total, "healthy": healthy, "draining": draining}

    def resize(self, n: int) -> int:
        """Elastic tier resize: grow to ``n`` by adding fresh members
        over the SAME loaded engine (its weights are shared, so a joining
        STT member is warm by construction), shrink by a zero-drop drain→flush→retire
        pipeline per victim: stop placement (``start_drain``), flush the
        victim batcher's queued and in-flight work, take it out of the
        ring, then stop the worker. Sticky utterances still mid-stream
        re-route on their next submit and re-anchor on the voice side's
        buffered PCM tail — the documented mid-utterance failover path,
        a bounded re-encode, never a loss. BLOCKING (the flush waits), so
        the autopilot calls it off the event loop. Returns the new member
        count; the floor is one replica."""
        n = max(1, int(n))
        with self._route_lock:
            while len(self.replicas) < n:
                r = self.add_member(f"stt-{self._next_idx}")
                self.batchers[r.idx] = self._make_batcher()
                self._seen[r.idx] = (0, time.monotonic())
        while True:
            with self._route_lock:
                if len(self.replicas) <= n:
                    break
                # newest member retires first: the long-lived members keep
                # the affinities (and cross-KV slots) they accumulated
                victim = self.replicas[-1]
                self.start_drain(victim)
            b = self.batchers.get(victim.idx)
            if b is not None and b.healthy():
                b.drain(30.0)  # flush queued + in-flight work: zero-drop
            with self._route_lock:
                self.remove_member(victim.url)
                b = self.batchers.pop(victim.idx, None)
                self._seen.pop(victim.idx, None)
            if b is not None:
                if b.healthy():
                    # stragglers that raced the removal: flush them too
                    b.drain(5.0)
                b.stop()
        return len(self.replicas)

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Quiesce every live replica (shutdown hygiene)."""
        ok = True
        for b in list(self.batchers.values()):
            if b.healthy():
                ok = b.drain(timeout_s) and ok
        return ok

    def stop(self) -> None:
        self._stop_evt.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
            self._watchdog = None
        for b in list(self.batchers.values()):
            b.stop()
        global _TIER
        if _TIER is self:
            _TIER = None
