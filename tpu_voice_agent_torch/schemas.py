"""Intent schema without pydantic: ParseRequest / ParseResponse as plain dicts.

The JAX package keeps its schema as pydantic models
(``tpu_voice_agent/schemas/intents.py``). The port runs where pydantic is not
installed, so it carries the same contract in two pieces:

- ``parse_response.schema.json``: ``ParseResponse.model_json_schema()``
  committed verbatim. The grammar compiles its regex from this file, and a CPU
  test holds it equal to the pydantic output.
- the validators below, which fill every default field exactly as
  ``ParseResponse.model_validate(obj).model_dump()`` does, so the 200 body of
  ``/parse`` is the same dict on both packages.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Any

# The 19-value intent vocabulary.
INTENT_TYPES: tuple[str, ...] = (
    "search",
    "navigate",
    "click",
    "type",
    "extract",
    "extract_table",
    "sort",
    "filter",
    "scroll",
    "back",
    "forward",
    "select",
    "wait_for",
    "upload",
    "screenshot",
    "summarize",
    "confirm",
    "cancel",
    "unknown",
)

# Intents that never auto-execute without the user's confirmation: the
# model's requires_confirmation bit, plus this server-side floor.
RISKY_INTENT_TYPES: frozenset[str] = frozenset({"upload", "confirm"})

TARGET_STRATEGIES: tuple[str, ...] = ("auto", "css", "text", "role", "aria", "xpath")

SCHEMA_PATH = Path(__file__).with_name("parse_response.schema.json")

_MAX_STR = 4096


class ValidationError(ValueError):
    """A payload that does not satisfy the schema (message names the field)."""


@lru_cache(maxsize=1)
def parse_response_schema() -> dict:
    """The committed JSON schema of ParseResponse (the grammar's source)."""
    return json.loads(SCHEMA_PATH.read_text())


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _int_field(v, name: str, lo: int, hi: int) -> int:
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    if not _is_int(v):
        raise ValidationError(f"{name}: input should be a valid integer")
    if not lo <= v <= hi:
        raise ValidationError(f"{name}: input should be in [{lo}, {hi}]")
    return v


def _bool_field(v, name: str) -> bool:
    if not isinstance(v, bool):
        raise ValidationError(f"{name}: input should be a valid boolean")
    return v


def _opt_str(v, name: str) -> str | None:
    if v is None:
        return None
    if not isinstance(v, str):
        raise ValidationError(f"{name}: input should be a valid string")
    if len(v) > _MAX_STR:
        raise ValidationError(f"{name}: string should have at most {_MAX_STR} characters")
    return v


def _scalar_map(v, name: str) -> dict:
    """``dict[str, str | int | float | bool | None]`` (values keep their
    JSON type, as pydantic's smart union does)."""
    if not isinstance(v, dict):
        raise ValidationError(f"{name}: input should be a valid dictionary")
    for k, x in v.items():
        if not isinstance(k, str):
            raise ValidationError(f"{name}: keys should be strings")
        if x is not None and not isinstance(x, (str, int, float, bool)):
            raise ValidationError(f"{name}.{k}: input should be a scalar")
    return dict(v)


def _check_keys(obj: dict, allowed: tuple[str, ...], name: str) -> None:
    extra = [k for k in obj if k not in allowed]
    if extra:
        raise ValidationError(f"{name}.{extra[0]}: extra inputs are not permitted")


def _target(v, name: str) -> dict | None:
    if v is None:
        return None
    if not isinstance(v, dict):
        raise ValidationError(f"{name}: input should be a valid dictionary")
    _check_keys(v, ("strategy", "value", "role", "name"), name)
    strategy = v.get("strategy", "auto")
    if strategy not in TARGET_STRATEGIES:
        raise ValidationError(f"{name}.strategy: unknown strategy {strategy!r}")
    return {
        "strategy": strategy,
        "value": _opt_str(v.get("value"), f"{name}.value"),
        "role": _opt_str(v.get("role"), f"{name}.role"),
        "name": _opt_str(v.get("name"), f"{name}.name"),
    }


def _intent(v, name: str) -> dict:
    if not isinstance(v, dict):
        raise ValidationError(f"{name}: input should be a valid dictionary")
    _check_keys(v, ("type", "target", "args", "priority", "requires_confirmation",
                    "timeout_ms", "retries"), name)
    if "type" not in v:
        raise ValidationError(f"{name}.type: field required")
    if v["type"] not in INTENT_TYPES:
        raise ValidationError(f"{name}.type: unknown intent type {v['type']!r}")
    return {
        "type": v["type"],
        "target": _target(v.get("target"), f"{name}.target"),
        "args": _scalar_map(v.get("args", {}), f"{name}.args"),
        "priority": _int_field(v.get("priority", 1), f"{name}.priority", 1, 5),
        "requires_confirmation": _bool_field(v.get("requires_confirmation", False),
                                             f"{name}.requires_confirmation"),
        "timeout_ms": _int_field(v.get("timeout_ms", 15_000), f"{name}.timeout_ms",
                                 0, 120_000),
        "retries": _int_field(v.get("retries", 0), f"{name}.retries", 0, 3),
    }


def validate_intent(obj: Any) -> dict:
    """One Intent (the voice service's ``confirm_execute`` frame) -> the
    ``Intent.model_validate(obj).model_dump()``-equal dict; raises
    ValidationError."""
    return _intent(obj, "Intent")


def is_risky(intent: dict) -> bool:
    """``Intent.is_risky``: the requires_confirmation bit or a risky type."""
    return bool(intent.get("requires_confirmation")) or intent["type"] in RISKY_INTENT_TYPES


def validate_parse_response(obj: Any) -> tuple[dict | None, str | None]:
    """Validate a decoded object against ParseResponse; returns (the
    ``model_dump()``-equal dict with every default filled, None) or
    (None, error)."""
    try:
        if not isinstance(obj, dict):
            raise ValidationError("input should be a valid dictionary")
        _check_keys(obj, ("version", "intents", "context_updates", "confidence",
                          "tts_summary", "follow_up_question"), "ParseResponse")
        version = obj.get("version", "1.0")
        if not isinstance(version, str):
            raise ValidationError("version: input should be a valid string")
        intents = obj.get("intents", [])
        if not isinstance(intents, list):
            raise ValidationError("intents: input should be a valid list")
        if len(intents) > 8:
            raise ValidationError("intents: list should have at most 8 items")
        if "confidence" not in obj:
            raise ValidationError("confidence: field required")
        conf = obj["confidence"]
        if isinstance(conf, bool) or not isinstance(conf, (int, float)):
            raise ValidationError("confidence: input should be a valid number")
        conf = float(conf)
        if not 0.0 <= conf <= 1.0:
            raise ValidationError("confidence: input should be in [0, 1]")
        return {
            "version": version,
            "intents": [_intent(it, f"intents.{i}") for i, it in enumerate(intents)],
            "context_updates": _scalar_map(obj.get("context_updates", {}),
                                           "context_updates"),
            "confidence": conf,
            "tts_summary": _opt_str(obj.get("tts_summary"), "tts_summary"),
            "follow_up_question": _opt_str(obj.get("follow_up_question"),
                                           "follow_up_question"),
        }, None
    except ValidationError as e:
        return None, str(e)


def parse_response_from_json(text: str) -> tuple[dict | None, str | None]:
    try:
        obj = json.loads(text)
    except json.JSONDecodeError as e:
        return None, f"invalid_json: {e}"
    return validate_parse_response(obj)


def validate_parse_request(obj: Any) -> dict:
    """``{text, session_id?, context, speculative?, prefix_feed?, tenant?}``
    -> the request dict with defaults; raises ValidationError."""
    if not isinstance(obj, dict):
        raise ValidationError("input should be a valid dictionary")
    _check_keys(obj, ("text", "session_id", "context", "speculative", "prefix_feed",
                      "tenant"), "ParseRequest")
    text = obj.get("text")
    if not isinstance(text, str):
        raise ValidationError("text: field required (a string)")
    if not 1 <= len(text) <= _MAX_STR:
        raise ValidationError(f"text: length should be in [1, {_MAX_STR}]")
    session_id = obj.get("session_id")
    if session_id is not None and not isinstance(session_id, str):
        raise ValidationError("session_id: input should be a valid string")
    context = obj.get("context", {})
    if not isinstance(context, dict):
        raise ValidationError("context: input should be a valid dictionary")
    tenant = obj.get("tenant")
    if tenant is not None and (not isinstance(tenant, str) or len(tenant) > 64):
        raise ValidationError("tenant: input should be a string of at most 64 characters")
    return {
        "text": text,
        "session_id": session_id,
        "context": context,
        "speculative": _bool_field(obj.get("speculative", False), "speculative"),
        "prefix_feed": _bool_field(obj.get("prefix_feed", False), "prefix_feed"),
        "tenant": tenant,
    }
