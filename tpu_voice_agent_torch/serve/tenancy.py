"""The multi-tenant QoS plane the batcher wires in when ``TENANT_CLASSES``
is set.

Port of ``tpu_voice_agent/serve/tenancy.py``:

- ``TenantClass`` rows parsed from ``name:weight[:slots=N][:blocks=N]
  [:rps=F][:p50=MS]`` entries, comma-separated (for example
  ``premium:4:slots=3:rps=20,free:1:rps=2``). A request names its tenant;
  an unknown or absent name falls into the implicit ``default`` class
  (weight 1, no caps).
- ``TenancyPlane``: per-tenant lanes with a virtual-token clock (start-time
  fair queuing: a lane's vtime advances by tokens / weight, and admission
  picks the eligible lane of smallest vtime, FIFO within a lane), a token
  bucket per lane (a refused submit sheds with the retryable ``shed:``
  prefix), slot caps, radix block quotas, rolling latency windows and
  per-tenant cost ledgers (``utils.costmodel.SessionCostLedger`` keyed by
  class name). Its lock covers submits from handler threads and the
  batcher's step on its own.
- ``FairLanes``: the same vtime discipline for the STT batcher, a sort-key
  prefix in front of its finals > spec_finals > partials priority.

With ``TENANT_CLASSES`` unset nothing here is built and every caller keeps
its single-tenant path.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..utils.costmodel import SessionCostLedger
from ..utils.tracing import get_metrics

DEFAULT_TENANT = "default"


def tenancy_enabled() -> bool:
    spec = os.environ.get("TENANT_CLASSES")
    return bool(spec and spec.strip())


@dataclass(frozen=True)
class TenantClass:
    """One row of the registry: ``weight`` sets the fair share; a cap of 0
    is no cap."""

    name: str
    weight: float = 1.0
    slots: int = 0  # most concurrent batcher slots
    blocks: int = 0  # radix block quota (the warm chains' footprint)
    rps: float = 0.0  # submit rate limit (token bucket, burst >= 1)
    p50_ms: float = 0.0  # SLO target (exported, not enforced)


def parse_tenant_classes(spec: str | None = None) -> dict[str, TenantClass]:
    """Parse a ``TENANT_CLASSES`` spec (None reads the knob). A malformed
    entry raises ``ValueError``: a silent fallback would drop isolation."""
    if spec is None:
        spec = os.environ.get("TENANT_CLASSES") or ""
    classes: dict[str, TenantClass] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        name = parts[0].strip()
        if not name:
            raise ValueError(f"TENANT_CLASSES entry with empty name: {entry!r}")
        weight, caps = 1.0, {}
        rest = parts[1:]
        if rest and "=" not in rest[0]:
            weight = float(rest[0])
            rest = rest[1:]
        if weight <= 0:
            raise ValueError(f"TENANT_CLASSES {name}: weight must be > 0")
        for tok in rest:
            if "=" not in tok:
                raise ValueError(f"TENANT_CLASSES {name}: bad field {tok!r}")
            k, v = tok.split("=", 1)
            k = k.strip()
            if k == "slots":
                caps["slots"] = int(v)
            elif k == "blocks":
                caps["blocks"] = int(v)
            elif k == "rps":
                caps["rps"] = float(v)
            elif k == "p50":
                caps["p50_ms"] = float(v)
            else:
                raise ValueError(f"TENANT_CLASSES {name}: unknown field {k!r}")
        classes[name] = TenantClass(name=name, weight=weight, **caps)
    classes.setdefault(DEFAULT_TENANT, TenantClass(name=DEFAULT_TENANT))
    return classes


class _Lane:
    __slots__ = ("cls", "vtime", "bucket", "bucket_at", "active", "queued", "tokens_total",
                 "throttled", "preemptions", "lat_ms")

    def __init__(self, cls: TenantClass):
        self.cls = cls
        self.vtime = 0.0  # the virtual-token clock (tokens / weight)
        self.bucket = max(1.0, cls.rps)  # rate-limit tokens (burst >= 1)
        self.bucket_at = time.monotonic()
        self.active = 0  # batcher slots held
        self.queued = 0  # requests waiting
        self.tokens_total = 0  # decoded tokens, lifetime
        self.throttled = 0
        self.preemptions = 0
        self.lat_ms: deque = deque(maxlen=64)  # recent request latencies


class TenancyPlane:
    """The batcher's QoS state machine; every mutator takes the plane's
    lock."""

    def __init__(self, classes: dict[str, TenantClass] | None = None):
        self.classes = classes if classes is not None else parse_tenant_classes()
        self._lock = threading.Lock()
        self._lanes = {name: _Lane(cls) for name, cls in self.classes.items()}
        self.ledgers = SessionCostLedger()

    def resolve(self, tenant: str | None) -> str:
        """A wire tag's class; unknown -> ``default`` (shared best effort,
        never a ride in another tenant's lane)."""
        if tenant and tenant in self._lanes:
            return tenant
        return DEFAULT_TENANT

    def lane(self, tenant: str | None) -> _Lane:
        return self._lanes[self.resolve(tenant)]

    def admit(self, tenant: str | None) -> bool:
        """The token bucket at submit: True admits, False throttles."""
        with self._lock:
            lane = self.lane(tenant)
            rps = lane.cls.rps
            if rps <= 0:
                return True
            now = time.monotonic()
            lane.bucket = min(max(1.0, rps), lane.bucket + (now - lane.bucket_at) * rps)
            lane.bucket_at = now
            if lane.bucket >= 1.0:
                lane.bucket -= 1.0
                return True
            lane.throttled += 1
            return False

    def on_queue(self, tenant: str | None) -> None:
        with self._lock:
            lane = self.lane(tenant)
            # an idle lane banks no credit: on (re)entry its clock jumps to
            # the busy lanes' minimum
            if lane.active == 0 and lane.queued == 0:
                busy = [ln.vtime for ln in self._lanes.values() if ln.active > 0 or ln.queued > 0]
                if busy:
                    lane.vtime = max(lane.vtime, min(busy))
            lane.queued += 1

    def on_dequeue(self, tenant: str | None, admitted: bool) -> None:
        with self._lock:
            lane = self.lane(tenant)
            lane.queued = max(0, lane.queued - 1)
            if admitted:
                lane.active += 1

    def on_release(self, tenant: str | None) -> None:
        with self._lock:
            lane = self.lane(tenant)
            lane.active = max(0, lane.active - 1)

    def reset_occupancy(self) -> None:
        """Zero the occupancy after a batcher reset (clocks, buckets and
        ledgers stay)."""
        with self._lock:
            for lane in self._lanes.values():
                lane.active = 0
                lane.queued = 0

    def pick(self, tenants: list[str | None]) -> int | None:
        """Index of the next waiter to admit: the smallest-vtime lane with
        slot headroom, FIFO within a lane; None when every waiter's lane is
        at its cap."""
        with self._lock:
            best_i, best_key = None, None
            for i, t in enumerate(tenants):
                lane = self.lane(t)
                if lane.cls.slots > 0 and lane.active >= lane.cls.slots:
                    continue
                key = (lane.vtime, i)
                if best_key is None or key < best_key:
                    best_i, best_key = i, key
            return best_i

    def charge(self, tenant: str | None, tokens: int) -> None:
        """Advance the lane's clock by decoded tokens / weight."""
        if tokens <= 0:
            return
        with self._lock:
            lane = self.lane(tenant)
            lane.vtime += tokens / lane.cls.weight
            lane.tokens_total += tokens

    def over_budget_victim(self, active: list[tuple[int, str | None]],
                           waiting: list[str | None]) -> int | None:
        """The slot to preempt: the active slot of the highest-vtime lane,
        only when a waiter's lane is strictly poorer and either starved (no
        active slot) or the victim's lane is over its slot cap; else None."""
        with self._lock:
            waiters: dict[str, float] = {}
            for t in waiting:
                name = self.resolve(t)
                lane = self._lanes[name]
                if lane.cls.slots > 0 and lane.active >= lane.cls.slots:
                    continue
                waiters.setdefault(name, lane.vtime)
            if not waiters:
                return None
            poorest = min(waiters.values())
            best_slot, best_v = None, None
            for slot, t in active:
                lane = self.lane(t)
                starving = any(self._lanes[w].active == 0 for w in waiters)
                over_cap = lane.cls.slots > 0 and lane.active > lane.cls.slots
                if lane.vtime <= poorest or not (starving or over_cap):
                    continue
                if best_v is None or lane.vtime > best_v:
                    best_slot, best_v = slot, lane.vtime
            return best_slot

    def note_preemption(self, tenant: str | None) -> None:
        with self._lock:
            self.lane(tenant).preemptions += 1

    def block_quota(self, tenant: str | None) -> int:
        return self.lane(tenant).cls.blocks

    def observe_latency(self, tenant: str | None, ms: float) -> None:
        with self._lock:
            self.lane(tenant).lat_ms.append(ms)

    def fold_cost(self, tenant: str | None, cost) -> None:
        """Roll a request's cost ledger into its tenant's."""
        self.ledgers.fold(self.resolve(tenant), cost)

    def export_gauges(self) -> None:
        """The ``tenant.*`` occupancy, share, latency and spend gauges."""
        m = get_metrics()
        with self._lock:
            m.set_gauge("tenant.lanes", float(len(self._lanes)))
            total = sum(ln.tokens_total for ln in self._lanes.values())
            for name, lane in self._lanes.items():
                m.set_gauge(f"tenant.active_slots.{name}", float(lane.active))
                m.set_gauge(f"tenant.queued.{name}", float(lane.queued))
                m.set_gauge(f"tenant.token_share.{name}",
                            (lane.tokens_total / total) if total else 0.0)
                if lane.lat_ms:
                    xs = sorted(lane.lat_ms)
                    m.set_gauge(f"tenant.p50_ms.{name}", xs[len(xs) // 2])
            for name, ent in self.ledgers.snapshot().items():
                m.set_gauge(f"tenant.spend_flops.{name}",
                            float(ent.get("prefill_flops", 0) + ent.get("decode_flops", 0)))

    def snapshot(self) -> dict:
        """``/debug/costs``' ``tenants``: per-lane occupancy and the rolled-up
        cost ledgers."""
        with self._lock:
            lanes = {}
            for name, lane in self._lanes.items():
                xs = sorted(lane.lat_ms)
                lanes[name] = {
                    "weight": lane.cls.weight,
                    "vtime": round(lane.vtime, 1),
                    "active": lane.active,
                    "queued": lane.queued,
                    "tokens": lane.tokens_total,
                    "throttled": lane.throttled,
                    "preemptions": lane.preemptions,
                    "p50_ms": (xs[len(xs) // 2] if xs else None),
                }
        return {"lanes": lanes, "ledgers": self.ledgers.snapshot()}


class FairLanes:
    """The vtime discipline of the STT batcher: ``rank`` is a sort-key
    prefix in front of its priority, so fairness reorders across tenants
    and each tenant's own order is the single-tenant one."""

    def __init__(self, classes: dict[str, TenantClass] | None = None):
        self.classes = classes if classes is not None else parse_tenant_classes()
        self._lock = threading.Lock()
        self._vtime: dict[str, float] = {}

    def _resolve(self, tenant: str | None) -> str:
        if tenant and tenant in self.classes:
            return tenant
        return DEFAULT_TENANT

    def rank(self, tenant: str | None) -> float:
        with self._lock:
            return self._vtime.get(self._resolve(tenant), 0.0)

    def charge(self, tenant: str | None, amount: float) -> None:
        name = self._resolve(tenant)
        w = self.classes[name].weight
        with self._lock:
            floor = min(self._vtime.values()) if self._vtime else 0.0
            cur = self._vtime.get(name, floor)
            self._vtime[name] = max(cur, floor) + amount / w
