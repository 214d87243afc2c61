"""The distilled intent checkpoint, carried into the port as plain numpy.

``data/intent-tiny-distilled.npz`` holds the JAX package's
``checkpoints/intent-tiny-distilled`` parameter tree (dim 192, 3 layers, 4/2
heads, head dim 48, the in-tree 619-token vocabulary) flattened with
``/``-joined keys, and ``data/intent_golden.json`` the JAX package's
``EngineParser`` output for golden utterances on it. Both are written by
``python tests/test_torch_golden.py --write``. ``data/intent_golden_kvquant.json``
holds the JAX package's batched paged parses of the same utterances under
``KV_QUANT=int8`` and ``int4`` and its ``kv_quant_differential`` (written by
``python tests/test_torch_kvquant_golden.py --write``). With real weights the card
can prove its tokens right, not just show that they run.
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path

from . import PACKAGE_DIR

DATA_DIR = PACKAGE_DIR / "data"
DISTILLED_NPZ = DATA_DIR / "intent-tiny-distilled.npz"
DISTILLED_META = DATA_DIR / "intent-tiny-distilled.json"
GOLDEN_JSON = DATA_DIR / "intent_golden.json"
KVQUANT_GOLDEN_JSON = DATA_DIR / "intent_golden_kvquant.json"


def distilled_prompt(text: str, context: dict) -> str:
    """The short serving prompt of distilled checkpoints (the task lives in
    the weights, so no few-shot prefix)."""
    user = json.dumps({"text": text, "context": context}, separators=(",", ":"))
    return f"<|user|>\n{user}\n<|assistant|>\n"


def load_distilled(device=None):
    """(LlamaConfig, params on ``device``) of the committed checkpoint."""
    from .bridge import load_npz
    from .models.llama import LlamaConfig
    from .serve.engine import resolve_device

    cfg = LlamaConfig(**json.loads(DISTILLED_META.read_text())["config"])
    return cfg, load_npz(DISTILLED_NPZ, device=resolve_device(device))


def intent_engine_from(cfg, params, max_new_tokens: int = 300, device=None, **engine_kw):
    """The serving engine + parser over distilled weights, configured as the
    JAX package's ``train.distill.intent_engine_from``: cache 512, prefill
    buckets (64, 128), no prefix, fast-forward off."""
    from .serve.engine import DecodeEngine
    from .services.brain import EngineParser

    eng = DecodeEngine(cfg=replace(cfg, max_seq_len=512), max_len=512,
                       prefill_buckets=(64, 128), init_weights=False, device=device,
                       **engine_kw)
    eng.load_params(params)
    return EngineParser(eng, max_new_tokens=max_new_tokens, render=distilled_prompt)


# the checkpoint's name: the last path component a ``distilled:<dir>``
# backend may name (the JAX package's ``checkpoints/intent-tiny-distilled``)
INTENT_CKPT = "intent-tiny-distilled"


def parser_from_env(backend: str, device=None, spec=None):
    """``BRAIN_BACKEND=distilled[:<dir>]``: the committed checkpoint behind
    ``intent_engine_from`` (``spec`` passed through, as JAX passes
    ``SPEC_ENABLE``). A directory is served when its last component is
    ``intent-tiny-distilled``, whose weights the port carries; any other is
    refused: such a directory is an orbax tree, whose reader comes with the
    training part of ROADMAP.md Queue 1 item 8 (an HF directory is served
    by ``BRAIN_MODEL``)."""
    if ":" in backend:
        path = backend.split(":", 1)[1]
        if Path(path.rstrip("/")).name != INTENT_CKPT:
            raise ValueError(f"BRAIN_BACKEND={backend!r}: the port carries only {INTENT_CKPT} "
                             "(the orbax reader comes with the training part of ROADMAP.md "
                             "Queue 1 item 8; an HF checkpoint directory is BRAIN_MODEL's)")
    return intent_engine_from(*load_distilled(device=device), device=device, spec=spec)


def golden_records() -> list[dict]:
    """The recorded JAX parses: [{"text", "context", "token_ids",
    "output", "response"}, ...]."""
    return json.loads(GOLDEN_JSON.read_text())["cases"]


def kvquant_golden_records() -> dict:
    """The recorded JAX KV_QUANT parses: {"tiers": {"int8" | "int4": [{"text",
    "context", "token_ids", "output", "finished"}, ...]}, "differential":
    kv_quant_differential's dict}."""
    return json.loads(KVQUANT_GOLDEN_JSON.read_text())
