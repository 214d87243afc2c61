"""Sequence parallelism of the port (``tpu_voice_agent/parallel``'s ring and
long-context prefill): ``sp_mesh``, ``ring_attention``, ``ulysses_attention``,
``llama_sp_prefill``, ``sp_pad_len``. The mesh is one process's list of
devices (``parallel.ring``'s docstring says why)."""

from .longctx import llama_sp_prefill, sp_pad_len
from .ring import ring_attention, sp_mesh, ulysses_attention

__all__ = ["ring_attention", "ulysses_attention", "sp_mesh", "llama_sp_prefill",
           "sp_pad_len"]
