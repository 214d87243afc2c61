"""Multi-host entry of the port: single-host meshes, refused multi-process.

Port of ``tpu_voice_agent/parallel/multihost.py``. JAX joins a multi-host
job (``jax.distributed.initialize`` from ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), after which every process runs
the same SPMD program over the global device list. The port is one
controller owning its mesh (``parallel.ring``'s docstring says why), and
JAX's multi-controller SPMD has no counterpart in it without a second
serving design, so:

- ``init_multihost`` is the single-process no-op (returns False) when no
  coordinator is set and the process count is unset or 1, and refuses any
  multi-process setting with a ``ValueError`` naming the three knobs and
  its ROADMAP item. Both services' ``main`` call it first, as JAX's do.
- ``multihost_mesh`` lays out (dp, tp) with each tp group on one host,
  ordered (process index, local index), and refuses a tp group that would
  straddle hosts. A ``torch.device`` carries no process index: every
  device of this process is process 0.
"""

from __future__ import annotations

import os

from .mesh import Mesh, visible_devices

MULTIHOST_KNOBS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """False for the single-process no-op; a multi-process setting (a
    coordinator, more than one process, a process id past 0) raises."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1) and process_id in (None, 0):
        return False
    raise ValueError(
        f"a multi-process runtime ({' / '.join(MULTIHOST_KNOBS)}: coordinator "
        f"{coordinator_address!r}, {num_processes} processes, process id {process_id}) is "
        "ROADMAP.md Queue 1 item 8 (8c's last piece): the port serves one process "
        "owning its devices; unset the three knobs")


def _process(d) -> int:
    return getattr(d, "process_index", 0)


def multihost_mesh(dp: int, tp: int, devices: list | None = None) -> Mesh:
    """(dp, tp) mesh with tp contiguous within a host: devices ordered
    (process index, local index); raises when a tp group would straddle
    hosts (its per-layer sums would cross the network)."""
    devices = sorted(devices if devices is not None else visible_devices(),
                     key=lambda d: (_process(d), getattr(d, "id", getattr(d, "index", None)) or 0))
    mesh = Mesh.from_devices((dp, tp), ("dp", "tp"), devices)
    for row in mesh.devices:
        hosts = {_process(d) for d in row}
        if len(hosts) > 1:
            raise ValueError(
                f"tp={tp} group straddles hosts {sorted(hosts)}: its per-layer "
                "all-reduces would cross hosts; shrink tp, raise dp, or even out "
                "per-host device counts")
    return mesh


def process_info(devices: list | None = None) -> dict:
    """The /health blob: one process holding every device of its mesh
    (default every visible card)."""
    n = len(devices if devices is not None else visible_devices())
    return {"process_index": 0, "process_count": 1, "local_devices": n, "global_devices": n}
