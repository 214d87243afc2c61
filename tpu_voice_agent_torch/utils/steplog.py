"""Per-step engine telemetry: the step ledger.

Port of ``tpu_voice_agent/utils/steplog.py``, with JAX's names. Every
``ContinuousBatcher.step`` records one bounded ring entry with its wall-time
decomposition, the stages in ``STAGES`` order:

    admit     queue and admission bookkeeping (prefill compute carved out)
    prefill   the step's admissions' prefill compute (the engine's
              ``_last_prefill_compute_ms`` per admission)
    draft     the drafter's host share of a speculative chunk (carved out
              of decode)
    decode    the ``decode_chunk`` call: the host's dispatch of the chunk
              (the plain loop's one-bool read per step included)
    readback  the scheduler's one combined ``.cpu()`` of the chunk: where
              the device work still queued surfaces on the host
    release   after the readback: commit, results, ``release_slot`` and
              radix inserts, gauge exports

plus batch occupancy, token and forward counts, and ``events``: the compile
sentinel's events recorded since the previous step (``utils.compilewatch``:
a watched entry point's cold call, or the kernel library's build), drained
once a step, so a stall lands on the step that paid it and counts in
``engine.step.compile_stalls``. The stages tile the wall by construction
(each ``lap`` closes at the next one's start). Every timing is a
``perf_counter`` call: no device sync.

Surfaces: the ``engine.step.*`` histograms and gauges, ``GET
/debug/steplog`` on the brain (``steplog_response``), and the ``steplog``
section of every flight-recorder freeze. ``STEPLOG_ENABLE=0`` records
nothing (tokens are the same either way); ``STEPLOG_STEPS`` sizes the ring
(default 256).
"""

from __future__ import annotations

import os
import threading
import time
from urllib.parse import parse_qs

# the tiling stage order
STAGES = ("admit", "prefill", "draft", "decode", "readback", "release")


class StepLog:
    """Bounded ring of per-step records."""

    def __init__(self, max_steps: int | None = None, enabled: bool | None = None):
        self.max_steps = max_steps if max_steps is not None \
            else int(os.environ.get("STEPLOG_STEPS", "256"))
        self.enabled = enabled if enabled is not None \
            else os.environ.get("STEPLOG_ENABLE", "1") != "0"
        self._lock = threading.Lock()
        self._steps: list[dict] = []
        self._seq = 0

    def timer(self) -> "StepTimer":
        return StepTimer(self)

    def record(self, rec: dict) -> None:
        """Append one step record and export its metrics; a no-op when
        disabled."""
        if not self.enabled:
            return
        from .tracing import get_metrics

        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._steps.append(rec)
            if len(self._steps) > self.max_steps:
                del self._steps[: len(self._steps) - self.max_steps]
        m = get_metrics()
        m.observe_ms("engine.step.wall", rec["wall_ms"])
        for stage, ms in rec["stages"].items():
            m.observe_ms(f"engine.step.{stage}", ms)
        m.set_gauge("engine.step.occupancy", float(rec.get("occupancy", 0)))
        m.set_gauge("engine.step.tokens", float(rec.get("tokens", 0)))
        if rec.get("events"):
            m.inc("engine.step.compile_stalls", float(len(rec["events"])))

    def last(self) -> dict | None:
        with self._lock:
            return dict(self._steps[-1]) if self._steps else None

    def steps(self, last: int | None = None) -> list[dict]:
        with self._lock:
            out = [dict(s) for s in self._steps]
        return out[-last:] if last else out

    def dump(self) -> dict:
        """The ``/debug/steplog`` body, also folded into flight-recorder
        freezes."""
        with self._lock:
            return {"enabled": self.enabled, "max_steps": self.max_steps,
                    "recorded": self._seq, "steps": [dict(s) for s in self._steps]}

    def clear(self) -> None:
        with self._lock:
            self._steps.clear()
            self._seq = 0


class StepTimer:
    """One scheduler step as contiguous wall segments: ``lap(stage)``
    closes the segment since the previous lap into ``stage``; ``carve``
    moves sub-time measured inside one stage into another; ``finish``
    records."""

    def __init__(self, log: StepLog):
        self._log = log
        self.t0 = time.perf_counter()
        self._t_last = self.t0
        self.stages: dict[str, float] = {}

    def lap(self, stage: str) -> None:
        now = time.perf_counter()
        self.stages[stage] = self.stages.get(stage, 0.0) + (now - self._t_last) * 1e3
        self._t_last = now

    def carve(self, from_stage: str, sub_stage: str, ms: float) -> None:
        if ms <= 0:
            return
        have = self.stages.get(from_stage, 0.0)
        ms = min(ms, have)  # the sub-time was measured inside from_stage
        self.stages[from_stage] = have - ms
        self.stages[sub_stage] = self.stages.get(sub_stage, 0.0) + ms

    def finish(self, **meta) -> dict:
        # the wall closes at the LAST lap: this recorder's own overhead
        # after it is no step time, so the stages tile the wall
        from .compilewatch import get_compile_watcher

        end = self._t_last if self.stages else time.perf_counter()
        rec = {
            "t_s": round(time.time(), 3),
            "wall_ms": round((end - self.t0) * 1e3, 3),
            "stages": {k: round(v, 3) for k, v in self.stages.items()},
            # the cold calls this step paid (drained once a step)
            "events": get_compile_watcher().take_pending(),
        }
        rec.update({k: v for k, v in meta.items() if v is not None})
        self._log.record(rec)
        return rec


_GLOBAL_STEPLOG = StepLog()


def get_steplog() -> StepLog:
    return _GLOBAL_STEPLOG


def steplog_response(service: str, request):
    """``GET /debug/steplog`` (a ``services.ws.Request`` in, a ``Response``
    out): the step ring; ``?last=K`` keeps the most recent K steps."""
    from ..services.ws import Response

    body = get_steplog().dump()
    try:
        last = int(parse_qs(request.query or "").get("last", ["0"])[0])
    except ValueError:
        last = 0
    if last > 0:
        body["steps"] = body["steps"][-last:]
    body["service"] = service
    return Response(200, body)
