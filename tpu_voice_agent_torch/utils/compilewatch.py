"""The compile sentinel: cold calls of the serving entry points, counted.

Port of ``tpu_voice_agent/utils/compilewatch.py``, with JAX's names and
knobs. JAX counts jit-cache misses: a call that traced and compiled an XLA
program. PyTorch runs eagerly and compiles nothing of its own, but a call at
an argument signature its site has not seen pays the port's cold-path costs
all the same: the kernel library's build or load, CUDA's lazy module
loading, and the caching allocator's growth to the new shapes (a
``cudaMalloc`` on the host's clock). A prompt in a prefill bucket nobody
warmed, or state rebuilt at a new shape after a restart, shows up as the
same unexplained p99 spike. So here:

- ``watch_compiles(site)`` wraps an entry point. A call whose signature the
  site has not seen (``_call_key``: the dtype and shape of every tensor
  argument, one level into dicts, lists and tuples, and the non-tensor
  arguments that pick a bucket or a kernel: bools, strings, None, frozen
  configs; plain ints and floats are values, not buckets, unless the site
  names them ``static``, as JAX's ``static_argnames`` do) is an event, its
  host wall the event's ``ms``. Watched calls nest (a decode step inside a
  chunk loop): the outermost cold call records one event for the stall, and
  the inner calls it makes only mark their signatures seen. A call that
  raises records nothing and leaves its signature unseen.
- ``ops._lib.build`` records its own event (site ``ops._lib.build``, the
  ``nvcc`` wall): the largest stall the port can take mid-serving.
- events feed the process-global ``CompileWatcher``: the ``xla.compiles`` /
  ``xla.compile_ms`` counters, a bounded event ring (``XLA_SENTINEL_EVENTS``,
  default 128), and a pending list the step ledger (``utils/steplog.py``)
  drains, so a cold call lands as an event on the scheduler step it stalled.
- the warmup fence: once armed (``arm_fence``), further events count as
  ``xla.compiles_post_fence`` and raise a ``/health`` warning.
  ``warm_restart`` (the dense and the paged engine) re-arms it; a silence of
  ``XLA_FENCE_QUIET_S`` (default 120 s) before an event arms it implicitly;
  ``XLA_EXPECTED_COMPILES`` (site prefixes) are counted but never flagged.

The metric names keep JAX's ``xla.`` prefix so dashboards, ``.env`` files and
the router's forwarding carry over; in the port they count cold calls, not
XLA compiles. Overhead: one signature tuple and two ``perf_counter`` calls
per watched call. ``XLA_SENTINEL=0`` disables the wrapping entirely
(callables pass through untouched).
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque

import torch


def _shape_sig(args: tuple, kwargs: dict, limit: int = 6) -> str:
    """Compact shape signature of a call, JAX's event label: the top-level
    tensor args' dtypes and shapes, containers by length, scalars by repr.
    Capped: this is an event label, not a dump."""
    parts: list[str] = []
    items = list(args) + [v for _, v in sorted(kwargs.items())]
    for a in items:
        if len(parts) >= limit:
            parts.append("…")
            break
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            parts.append(f"{str(dtype).removeprefix('torch.')}[{','.join(str(s) for s in shape)}]")
        elif isinstance(a, dict):
            parts.append(f"dict({len(a)})")
        elif isinstance(a, (list, tuple)):
            parts.append(f"seq({len(a)})")
        elif isinstance(a, (int, float, bool, str)) or a is None:
            parts.append(repr(a)[:24])
        # anything else (engines, generators, callables) is static config
        # that rarely distinguishes a cold call: skipped
    return " ".join(parts)


def _leaf_key(a):
    """One argument's part of the signature; ``...`` for what never picks a
    bucket or a kernel."""
    if isinstance(a, torch.Tensor):
        return (a.dtype, tuple(a.shape), a.device.type)
    if a is None or isinstance(a, (bool, str)):
        return a
    if getattr(a, "__dataclass_params__", None) is not None and a.__dataclass_params__.frozen:
        return a  # a frozen config (LlamaConfig, WhisperConfig, MelConfig): hashable
    return ...


def _call_key(args: tuple, kwargs: dict, static: tuple = ()) -> tuple:
    """The signature a site remembers: every argument's ``_leaf_key``, and
    one level into dicts (by key), lists and tuples (a parameter tree's
    ``layers`` list is summarized by its length and first element); the
    keyword arguments named in ``static`` by value."""

    def key(a):
        if isinstance(a, dict):
            return ("dict", tuple((k, _leaf_key(v)) for k, v in a.items()))
        if isinstance(a, (list, tuple)) and not isinstance(a, torch.Size):
            if len(a) > 8:
                return ("seq", len(a), _leaf_key(a[0]))
            return ("seq", tuple(_leaf_key(v) for v in a))
        return _leaf_key(a)

    return (tuple(key(a) for a in args),
            tuple((k, v if k in static else key(v)) for k, v in sorted(kwargs.items())))


class CompileWatcher:
    """Process-global cold-call event collector + warmup fence (JAX's
    class as it stands)."""

    def __init__(self, max_events: int | None = None):
        self.max_events = max_events if max_events is not None \
            else int(os.environ.get("XLA_SENTINEL_EVENTS", "128"))
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=self.max_events)
        self._pending: list[dict] = []  # drained by the step ledger
        self._fence_armed = False
        self._fence_reason: str | None = None
        self._compiles = 0
        self._compile_ms = 0.0
        self._post_fence = 0
        self._last: dict | None = None
        # auto-arm: an event landing after XLA_FENCE_QUIET_S of silence arms
        # the fence implicitly: serving that stopped paying cold calls for
        # that long was warm
        self._quiet_s = float(os.environ.get("XLA_FENCE_QUIET_S", "120"))
        self._last_compile_t: float | None = None

    # ------------------------------------------------------------ fence

    def arm_fence(self, reason: str = "manual") -> None:
        """Declare serving warm: every event from here on is a named,
        alertable one (``xla.compiles_post_fence`` + /health warning).
        Idempotent; ``warm_restart`` re-arms."""
        with self._lock:
            self._fence_armed = True
            self._fence_reason = reason

    def disarm_fence(self) -> None:
        with self._lock:
            self._fence_armed = False
            self._fence_reason = None

    @property
    def fence_armed(self) -> bool:
        return self._fence_armed

    # ------------------------------------------------------------ record

    def record(self, site: str, ms: float, signature: str) -> dict:
        from .tracing import get_metrics, log_event

        # the expected-compile allowlist: site prefixes declared legitimately
        # lazy (XLA_EXPECTED_COMPILES="stt.,spec."): counted and ringed, never
        # flagged post-fence. Read per event, so it tunes without a restart.
        allow = tuple(s for s in os.environ.get("XLA_EXPECTED_COMPILES", "").split(",") if s)
        expected = any(site.startswith(a) for a in allow)
        with self._lock:
            now_m = time.monotonic()
            if (not self._fence_armed and self._quiet_s > 0
                    and self._last_compile_t is not None
                    and now_m - self._last_compile_t > self._quiet_s):
                self._fence_armed = True
                self._fence_reason = f"auto: {self._quiet_s:g}s compile-quiet"
            self._last_compile_t = now_m
            post_fence = self._fence_armed and not expected
        ev = {
            "site": site,
            "ms": round(ms, 3),
            "shape": signature,
            "t_s": round(time.time(), 3),
            "post_fence": post_fence,
        }
        with self._lock:
            self._events.append(ev)
            if len(self._pending) < self.max_events:
                self._pending.append(ev)
            self._compiles += 1
            self._compile_ms += ms
            if ev["post_fence"]:
                self._post_fence += 1
            self._last = ev
        m = get_metrics()
        m.inc("xla.compiles")
        m.inc("xla.compile_ms", ms)
        if ev["post_fence"]:
            m.inc("xla.compiles_post_fence")
            # the alertable line: a cold call after the warmup fence names
            # its site and bucket
            log_event("xla", "recompile_after_fence", site=site, ms=round(ms, 1),
                      shape=signature)
        return ev

    # ------------------------------------------------------------ reading

    def take_pending(self) -> list[dict]:
        """Drain the events recorded since the last drain (the step ledger
        calls this once a scheduler step)."""
        with self._lock:
            out, self._pending = self._pending, []
        return out

    def events(self, last: int | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return evs[-last:] if last else evs

    def state(self) -> dict:
        """The /health surface: counters, fence status, the last event, and
        a warning line once post-fence events occurred."""
        with self._lock:
            body = {
                "compiles": self._compiles,
                "compile_ms": round(self._compile_ms, 1),
                "fence_armed": self._fence_armed,
                "fence_reason": self._fence_reason,
                "post_fence_compiles": self._post_fence,
                "last": dict(self._last) if self._last else None,
            }
        if body["post_fence_compiles"]:
            last = body["last"] or {}
            body["warning"] = (
                f"{body['post_fence_compiles']} recompile(s) after the "
                f"warmup fence (last: {last.get('site')} "
                f"{last.get('ms', 0):.0f} ms)")
        return body

    def reset(self) -> None:
        """Tests only: the watcher is process-global and tests share it.
        The sites' seen signatures stay (``forget_signatures``)."""
        with self._lock:
            self._events.clear()
            self._pending.clear()
            self._fence_armed = False
            self._fence_reason = None
            self._compiles = 0
            self._compile_ms = 0.0
            self._post_fence = 0
            self._last = None
            self._last_compile_t = None


_GLOBAL_WATCHER = CompileWatcher()
# every watched site's seen signatures, by site name
_SEEN: dict[str, set] = {}
_SEEN_LOCK = threading.Lock()
_DEPTH = threading.local()  # is a watched call on this thread recording?


def get_compile_watcher() -> CompileWatcher:
    return _GLOBAL_WATCHER


def forget_signatures() -> None:
    """Make every site cold again: its next call at any signature is an
    event. For tests, and for a run that wants the next calls named."""
    with _SEEN_LOCK:
        for seen in _SEEN.values():
            seen.clear()


def watch_compiles(site: str, static: tuple[str, ...] = ()):
    """Decorator for a serving entry point: count its cold calls as events
    tagged ``site``; ``static`` names keyword arguments whose value picks a
    bucket (as JAX's ``static_argnames``). Passes the callable through
    untouched when the sentinel is disabled (``XLA_SENTINEL=0``)."""

    def deco(fn):
        if os.environ.get("XLA_SENTINEL", "1") == "0":
            return fn
        with _SEEN_LOCK:
            seen = _SEEN.setdefault(site, set())

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            key = _call_key(args, kwargs, static)
            with _SEEN_LOCK:
                cold = key not in seen
                if cold:
                    seen.add(key)  # claimed: a concurrent twin records nothing
            if not cold:
                return fn(*args, **kwargs)
            outer = getattr(_DEPTH, "recording", False)
            _DEPTH.recording = True
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except BaseException:
                with _SEEN_LOCK:
                    seen.discard(key)
                raise
            finally:
                _DEPTH.recording = outer
            if not outer:
                # the cold call's host wall is the stall (device work the
                # call queued and did not wait for is not in it)
                _GLOBAL_WATCHER.record(site, (time.perf_counter() - t0) * 1e3,
                                       _shape_sig(args, kwargs))
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    return deco
