"""Shared set-up of the fleet tests (``tests/test_torch_router.py``,
``test_torch_timeseries.py``, ``test_torch_replicaset.py``,
``test_torch_autopilot.py``): plain HTTP calls, counter deltas and session
ids homed on a chosen member. The router under test runs in
``tpu_voice_agent_torch.services.router.RouterThread``; the members behind
it are the JAX tests' own aiohttp stand-ins or real brains of either
package."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from tpu_voice_agent_torch.services.replicaset import rendezvous_weight
from tpu_voice_agent_torch.utils.tracing import get_metrics


def post(url: str, body: dict, timeout: float = 30.0, headers: dict | None = None):
    """(status, headers, JSON body or {}) of one POST; an HTTP error answer
    is returned, not raised."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        raw = e.read().decode()
        return e.code, dict(e.headers), json.loads(raw) if raw else {}


def get(url: str, timeout: float = 10.0):
    """(status, JSON body) of one GET."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def counters() -> dict:
    return dict(get_metrics().snapshot()["counters"])


def delta(before: dict, name: str) -> float:
    return counters().get(name, 0.0) - before.get(name, 0.0)


def sid_homed_on(robj, idx: int, prefix: str) -> str:
    """A session id whose rendezvous home is member ``idx``."""
    urls = [r.url for r in robj.replicas]
    for i in range(10_000):
        sid = f"{prefix}{i}"
        if max(range(len(urls)), key=lambda j: rendezvous_weight(urls[j], sid)) == idx:
            return sid
    raise AssertionError("no session hashed onto the target replica")


def close_all(*servers) -> None:
    for s in servers:
        try:
            s.__exit__(None, None, None)
        except Exception:  # noqa: BLE001 - teardown of an already-stopped stand-in
            pass
