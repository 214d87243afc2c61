"""Device bring-up under a watchdog: the first CUDA touch of a process.

Port of ``tpu_voice_agent/utils/devinit.py``'s ``devices_with_watchdog``: a
first device touch can hang in the CUDA runtime (a wedged card, a stuck context)
or fail fast. A hang blocks in C, so no in-thread recovery exists: a
watchdog thread ends the process with a message that names the card. A
failure raises. ``require_card`` is called by the services' ``main`` when
the device they serve on is the card, and by ``chip_smoke.py``'s ``card``
phase.

Not ported, by design: JAX's ``reexec_on_cpu`` and the CPU pin inside
``devices_with_watchdog`` re-run the process on the CPU after a failed
init; the port never falls back to the CPU (an entry point runs on the
card unless its caller names the CPU). ``pin_platform_from_env`` works
around JAX's own platform plugin, which PyTorch does not have.
"""

from __future__ import annotations

import os
import sys
import threading

import torch

WATCHDOG_DEFAULT_S = 240.0
HANG_EXIT = 7  # the process's exit code when the first touch hangs


def _touch(index: int) -> str:
    """Allocate on the card and wait for it: the first touch that creates
    the context. Returns the card's name."""
    torch.zeros(1, device=f"cuda:{index}")
    torch.cuda.synchronize(index)
    return torch.cuda.get_device_name(index)


def _on_hang(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
    os._exit(HANG_EXIT)


def require_card(timeout_s: float = WATCHDOG_DEFAULT_S, index: int = 0) -> str:
    """Bring up ``cuda:<index>`` under a watchdog and return its name. No
    CUDA device, or an init that fails, raises ``RuntimeError``; an init
    still blocked after ``timeout_s`` ends the process with ``HANG_EXIT``
    and a message naming the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port serves on the card "
                           "(name the CPU explicitly to run the plain versions)")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "unset")
    done = threading.Event()

    def watchdog():
        if not done.wait(timeout_s):
            _on_hang(f"device init: the first touch of cuda:{index} "
                     f"(CUDA_VISIBLE_DEVICES={visible}) hung > {timeout_s:.0f} s")

    threading.Thread(target=watchdog, daemon=True, name="devinit-watchdog").start()
    try:
        return _touch(index)
    except Exception as e:  # noqa: BLE001 - re-raised with the card named
        raise RuntimeError(f"device init of cuda:{index} failed: {e}") from e
    finally:
        done.set()


def require_card_unless_cpu(device: str | None,
                            timeout_s: float = WATCHDOG_DEFAULT_S) -> str | None:
    """The services' gate: ``device`` as their ``*_DEVICE`` knob names it
    (None: the card). The CPU needs no bring-up (None back); any CUDA device
    goes through ``require_card``."""
    dev = torch.device(device or "cuda")
    if dev.type == "cpu":
        return None
    return require_card(timeout_s, dev.index or 0)
