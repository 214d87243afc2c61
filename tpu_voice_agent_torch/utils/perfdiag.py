"""Decode-performance diagnosis: where the weights' bytes go in a decode step.

Port of ``tpu_voice_agent/utils/perfdiag.py``. JAX lowers the decode
forward and scans the optimized HLO for a materialized int8 dequantization
(a weight-sized ``convert`` / ``multiply`` buffer: the int8 read, a wide
write and a wide read where one int8 read would do). PyTorch has no HLO: it
runs the forward eagerly, so the same question is asked of the ops it ran.

- ``decode_step_profile(engine)``: one T = 1 decode forward at the engine's
  serving shapes (its weights, one row over a scratch cache of its
  ``max_len``, as JAX's ``decode_step_hlo`` lowers it) under
  ``torch.profiler`` with ``record_shapes``; returns every op event's name,
  input shapes and dtypes. The engine's own cache and pool are not touched.
- ``audit_dequant(events, min_bytes=8 << 20)``: JAX's dict (``findings``,
  ``scanned_instructions``). A finding is an op that materialised a
  floating-point copy, at least ``min_bytes`` of it, of an int8 tensor:
  today ``models.llama._qe``'s int8 -> activation-dtype copy of every
  quantized matmul weight (``aten::copy_`` from int8), one a matmul a
  forward.
- ``capture_profile(engine, prompt, out_dir)``: a Chrome trace of one
  generation; ``marginal_ms_per_token``: decode ms a token as the slope over
  two generation lengths (the port's ``generate`` has no ``ignore_eos``, so
  a run that stops early is read at the steps it took).

It reports and changes nothing; the fused int8 product is ROADMAP.md's
held speed item.
"""

from __future__ import annotations

import os

import torch

_INT8 = ("signed char",)
_FLOATS = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8}


def _activities(device: torch.device):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def decode_step_profile(engine) -> list[dict]:
    """Op events of one T = 1 decode forward at the engine's shapes: a dict
    per event with ``name``, ``shapes`` and ``dtypes`` (the profiler's
    record_shapes view; device kernels carry no shapes)."""
    from torch.profiler import profile

    from ..models.llama import forward, init_kv_cache

    dev = engine.device
    cache = init_kv_cache(engine.cfg, 1, engine.max_len, device=dev)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    with torch.no_grad(), profile(activities=_activities(dev), record_shapes=True) as prof:
        forward(engine.params, engine.cfg, tok, pos, cache, attn_impl=engine.kernels)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return [{"name": e.name(), "shapes": [list(s) for s in e.shapes()],
             "dtypes": list(e.dtypes())}
            for e in prof.profiler.kineto_results.events()]


def audit_dequant(events: list[dict], min_bytes: int = 8 << 20) -> dict:
    """Find the ops that materialised a floating-point copy of an int8
    tensor of at least ``min_bytes``: ``aten::copy_`` whose source is int8
    and whose destination is a float type. Returns {findings: [(op, dtype,
    shape, mbytes, what)], scanned_instructions: N}, JAX's keys."""
    findings = []
    for e in events:
        if e["name"] != "aten::copy_" or len(e["dtypes"]) < 2 or len(e["shapes"]) < 1:
            continue
        dst, src = e["dtypes"][0], e["dtypes"][1]
        if src not in _INT8 or dst not in _FLOATS:
            continue
        shape = tuple(int(d) for d in e["shapes"][0])
        size = _FLOATS[dst]
        for d in shape:
            size *= d
        if size >= min_bytes:
            findings.append(("copy_", dst.removeprefix("c10::").lower(), shape,
                             round(size / 2**20, 1), "int8 dequant"))
    return {"findings": findings, "scanned_instructions": len(events)}


def capture_profile(engine, prompt: str, out_dir: str, max_new_tokens: int = 64) -> str:
    """One profiler trace around a constrained generation, written as a
    Chrome trace; returns its path. A one-slot engine runs ``generate``; a
    batched or paged one a ``ContinuousBatcher`` of its own over the
    engine, which must be idle (no serving loop stepping it)."""
    from torch.profiler import profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    with profile(activities=_activities(engine.device)) as prof:
        if engine.batch_slots == 1 and getattr(engine, "allocator", None) is None:
            engine.generate(prompt, max_new_tokens=max_new_tokens, greedy=True)
        else:
            from ..serve.scheduler import ContinuousBatcher

            ContinuousBatcher(engine, max_new_tokens=max_new_tokens).generate_many([prompt])
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
    prof.export_chrome_trace(path)
    return path


def marginal_ms_per_token(engine, prompt: str, lengths=(64, 192), tries: int = 3,
                          with_steps: bool = False):
    """Marginal decode ms a token by slope over two generation lengths:
    cancels the fixed prefill and dispatch cost that poisons ms/steps at
    short lengths. ``with_steps=True`` returns (slope, (steps_lo, steps_hi))
    so callers report the steps the slope spans."""
    pts: dict[int, float] = {}
    for n in lengths:
        best = None
        for _ in range(tries):
            r = engine.generate(prompt, max_new_tokens=n, constrained=False,
                                byte_budget=1_000_000)
            best = r if best is None or r.decode_ms < best.decode_ms else best
        if best.steps > 0:
            pts[best.steps] = min(pts.get(best.steps, best.decode_ms), best.decode_ms)
    ks = sorted(pts)
    slope = None
    if len(ks) >= 2 and ks[-1] > ks[0]:
        s = (pts[ks[-1]] - pts[ks[0]]) / (ks[-1] - ks[0])
        # a non-positive slope is host noise, not a rate: no reading
        if s > 0:
            slope = s
    if with_steps:
        return slope, (ks[0], ks[-1]) if len(ks) >= 2 else None
    return slope
