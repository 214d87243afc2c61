"""PyTorch + CUDA port of tpu_voice_agent for NVIDIA Hopper (H100).

A package of its own beside the JAX package: it imports ``torch`` and never
``jax`` or ``tpu_voice_agent``. Every Pallas kernel on a ported path is a
hand-written CUDA kernel under ``csrc/`` with a plain PyTorch version beside
it in ``ops/``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import os
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent


def cache_dir() -> Path:
    """Where built artifacts go (the kernel library, the intent-DFA cache):
    ``$TPU_VOICE_CACHE_DIR`` when set, else ``_build/`` inside the package
    (listed in .gitignore)."""
    env = os.environ.get("TPU_VOICE_CACHE_DIR")
    return Path(env) if env else PACKAGE_DIR / "_build"
