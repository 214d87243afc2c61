"""Deterministic, environment-gated fault injection: the seeded chaos points.

Port of ``tpu_voice_agent/utils/chaos.py``, with JAX's names, spec grammar
and seeding, so one spec and seed fire on the same events in both packages:

- Off means off: with ``CHAOS_FAULTS`` unset, ``chaos_fire()`` is a dict
  miss and a bool test (no draw, no metric).
- Deterministic: each point draws from its own ``random.Random(f"{seed}:{point}")``,
  so the k-th event of a point answers the same way for a spec and seed.
- Observable: every injected fault counts ``chaos.injected`` and
  ``chaos.<point>``; an armed process registers ``chaos.injected`` at 0.

Spec grammar (``CHAOS_FAULTS`` or ``configure()``), comma-separated:
``point:0.05`` fires with probability 0.05 per event, ``point@7`` on the
7th event only, ``point:1`` on every event. An unknown point raises
``ValueError``, so a typo never disables a drill silently.

Where the port fires each point: ``nan_logits`` and ``dead_fsm`` at the
scheduler's admission (NaN logits on the slot's next chunk, its FSM state
forced to -1), ``prefill_exc`` at the top of ``DecodeEngine.prefill_slot``,
``alloc_fail`` in ``BlockAllocator.alloc``, ``stall_step`` at the top of
``ContinuousBatcher.step`` (it sleeps ``CHAOS_STALL_S``), ``drop_frame`` on
the voice service's binary frames, ``stt_garble`` in
``serve.stt.finalize_stt_ids``, ``intent_downgrade``, ``replica_kill`` /
``replica_hang`` / ``replica_slow`` / ``replica_degrade`` on the brain's
``POST /parse``, ``replica_join_stall`` on its ``POST /admin/handoff``
(it sleeps ``CHAOS_HANG_S``), ``prefill_replica_kill`` between the frame
writes of its ``POST /admin/disagg/prefill``, and ``stt_replica_kill`` /
``stt_replica_hang`` in ``serve.stt_batch.STTBatcher``'s worker (a kill as
it takes a batch, a ``CHAOS_HANG_S`` sleep before one).
The port serves every point of JAX's plane; ``check_served_points`` refuses
at boot a spec naming an unknown one.
"""

from __future__ import annotations

import os
import random
import threading

KNOWN_POINTS = ("nan_logits", "dead_fsm", "prefill_exc", "alloc_fail",
                "stall_step", "drop_frame", "replica_kill", "replica_hang",
                "replica_slow", "replica_degrade", "stt_replica_kill",
                "stt_replica_hang", "stt_garble", "intent_downgrade",
                "replica_join_stall", "prefill_replica_kill")


class ChaosError(RuntimeError):
    """An injected (not organic) fault. Not a device fault: containment
    handles it per request."""


class Chaos:
    """One parsed fault spec. Thread-safe: the serving thread, the HTTP
    handler threads and the allocator fire concurrently."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.seed = seed
        self.rules: dict[str, tuple[str, float]] = {}
        self.counts: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._lock = threading.Lock()
        spec = (spec or "").strip()
        if spec:
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                if "@" in part:
                    point, _, k = part.partition("@")
                    self.rules[point.strip()] = ("nth", float(int(k)))
                else:
                    point, _, p = part.partition(":")
                    self.rules[point.strip()] = ("prob", float(p or 1.0))
            for point in self.rules:
                if point not in KNOWN_POINTS:
                    raise ValueError(
                        f"unknown chaos point {point!r} (known: {KNOWN_POINTS})")
        if self.rules:
            # an armed drill scrapes as 0 before its first fault; a
            # chaos-off process exports nothing
            from .tracing import get_metrics

            get_metrics().inc("chaos.injected", 0.0)

    @property
    def enabled(self) -> bool:
        return bool(self.rules)

    def fire(self, point: str) -> bool:
        """Count one event at ``point``; True when the fault injects."""
        rule = self.rules.get(point)
        if rule is None:
            return False
        with self._lock:
            n = self.counts.get(point, 0) + 1
            self.counts[point] = n
            kind, arg = rule
            if kind == "nth":
                hit = n == int(arg)
            else:
                rng = self._rngs.get(point)
                if rng is None:
                    rng = self._rngs[point] = random.Random(f"{self.seed}:{point}")
                hit = rng.random() < arg
        if hit:
            from .tracing import get_metrics

            m = get_metrics()
            m.inc("chaos.injected")
            m.inc(f"chaos.{point}")
        return hit


_chaos: Chaos | None = None
_chaos_lock = threading.Lock()


def get_chaos() -> Chaos:
    """The process-global controller; the first call reads ``CHAOS_FAULTS``
    and ``CHAOS_SEED``."""
    global _chaos
    if _chaos is None:
        with _chaos_lock:
            if _chaos is None:
                _chaos = Chaos(os.environ.get("CHAOS_FAULTS", ""),
                               int(os.environ.get("CHAOS_SEED", "0")))
    return _chaos


def configure(spec: str, seed: int = 0) -> Chaos:
    """Install a fresh controller (counts start at 0)."""
    global _chaos
    with _chaos_lock:
        _chaos = Chaos(spec, seed)
    return _chaos


def reset() -> None:
    """Back to the environment-derived lazy controller."""
    global _chaos
    with _chaos_lock:
        _chaos = None


def chaos_fire(point: str) -> bool:
    """The call sites' one line: False at once when chaos is off."""
    c = get_chaos()
    return c.enabled and c.fire(point)


def check_served_points() -> None:
    """Refuse at boot a ``CHAOS_FAULTS`` that names an unknown point
    (``Chaos``'s own ``ValueError``)."""
    raw = os.environ.get("CHAOS_FAULTS", "").strip()
    if raw:
        Chaos(raw)
