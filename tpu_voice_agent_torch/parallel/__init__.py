"""Parallelism of the port (``tpu_voice_agent/parallel``): the dp x tp mesh
and its placement plans (``mesh``), sequence parallelism (``ring``,
``longctx``), pipeline parallelism (``pipeline``), expert parallelism
(``expert``) and the multi-host entry (``multihost``). A mesh is one
process's grid of devices (``parallel.ring``'s docstring says why).

The names below load their module on first use: ``models.llama`` and
``ops`` import ``parallel.mesh``, and the pipeline imports them back.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh", "ShardingRules": "mesh", "default_rules": "mesh",
    "param_shardings": "mesh", "kv_cache_shardings": "mesh",
    "llama_sp_prefill": "longctx", "sp_pad_len": "longctx",
    "init_multihost": "multihost", "multihost_mesh": "multihost",
    "process_info": "multihost",
    "ring_attention": "ring", "sp_mesh": "ring", "ulysses_attention": "ring",
    "llama_pp_forward": "pipeline", "pipeline_apply": "pipeline", "pp_mesh": "pipeline",
    "stage_param_shardings": "pipeline", "stage_params": "pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
