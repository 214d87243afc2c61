"""JSON Schema (pydantic subset) -> regex for constrained decoding.

Compiles ``Model.model_json_schema()`` output into a regex accepted by
``regexlang.compile_regex``. The generated language is a *subset* of the
schema's language chosen for small DFAs and unambiguous decoding:

- objects emit ALL properties, in declaration order, compact (no whitespace);
  optional/nullable fields are emitted as ``null`` rather than omitted
- strings are printable-ASCII with JSON escapes, DFA-bounded at
  ``min(maxLength, 160)`` chars: every grammar path therefore terminates
  within a bounded byte count, so even a worst-case (random-weight) model
  under greedy decoding reaches EOS instead of cycling inside a free string
  until the byte budget truncates
- integers bounded by digit count chosen to stay <= the schema's maximum
- free-form objects (additionalProperties) allow up to 4 key/value pairs

Subset property (everything the DFA accepts validates under pydantic) is
enforced by tests that random-walk the DFA and validate samples.
"""

from __future__ import annotations

import math
from typing import Any

# JSON string contents: printable ASCII minus `"` and `\`, or a JSON escape.
STR_CHAR = r'(\\["\\/bfnrt]|[ !#-\[\]-~])'
# DFA-level string length cap (see module docstring). Each bounded string
# costs ~cap DFA states per occurrence; 160 covers every realistic utterance
# fragment, URL, and tts summary while keeping the DFA in the low tens of
# thousands of states.
DEFAULT_MAX_STRING = 160
STRING = '"' + STR_CHAR + "{0,%d}" % DEFAULT_MAX_STRING + '"'
# Non-empty variant (for keys etc.)
STRING_NONEMPTY = '"' + STR_CHAR + "{1,%d}" % DEFAULT_MAX_STRING + '"'


def _string_regex(max_length: int | None) -> str:
    n = DEFAULT_MAX_STRING if max_length is None else min(int(max_length), DEFAULT_MAX_STRING)
    return '"' + STR_CHAR + "{0,%d}" % n + '"'
KEY = r'"[a-zA-Z_][a-zA-Z0-9_\-]{0,30}"'
BOOL = "(true|false)"
NULL = "null"

FRAC = r"(\.\d{1,6})?"
FRAC0 = r"(\.0{1,6})?"
_UNBOUNDED = 999_999_999


def _digits_range(a: str, b: str) -> str:
    """Regex for fixed-length digit strings in [a, b] (same length)."""
    if a == b:
        return a
    if set(a) == {"0"} and set(b) == {"9"}:
        # full span shortcut — prevents O(3^digits) recursion blowup
        return r"\d" if len(a) == 1 else r"\d{%d}" % len(a)
    i = 0
    while a[i] == b[i]:
        i += 1
    pre = a[:i]
    da, db = int(a[i]), int(b[i])
    rest = len(a) - i - 1
    if rest == 0:
        body = f"[{da}-{db}]" if db > da else str(da)
        return pre + body
    parts = [str(da) + _digits_range(a[i + 1 :], "9" * rest)]
    if db - da >= 2:
        mid = f"[{da + 1}-{db - 1}]" if db - da > 2 else str(da + 1)
        mid += r"\d" if rest == 1 else r"\d{%d}" % rest
        parts.append(mid)
    parts.append(str(db) + _digits_range("0" * rest, b[i + 1 :]))
    return pre + "(" + "|".join(parts) + ")"


def int_range_regex(lo: int, hi: int) -> str:
    """Exact regex for decimal integers in [lo, hi], lo >= 0, no leading zeros."""
    if not 0 <= lo <= hi:
        raise ValueError(f"bad integer range [{lo}, {hi}]")
    parts = []
    for d in range(len(str(lo)), len(str(hi)) + 1):
        dlo = 0 if d == 1 else 10 ** (d - 1)
        dhi = 10**d - 1
        a, b = max(lo, dlo), min(hi, dhi)
        if a > b:
            continue
        if a == dlo and b == dhi and d > 1:
            # full width-d span: [1-9]\d{d-1}
            parts.append(r"[1-9]\d" if d == 2 else r"[1-9]\d{%d}" % (d - 1))
        else:
            parts.append(_digits_range(str(a), str(b)))
    return "(" + "|".join(parts) + ")" if len(parts) > 1 else parts[0]


def _int_regex(minimum: float | None, maximum: float | None) -> str:
    lo = -_UNBOUNDED if minimum is None else math.ceil(minimum)
    hi = _UNBOUNDED if maximum is None else math.floor(maximum)
    if lo > hi:
        raise ValueError(f"empty integer range [{minimum}, {maximum}]")
    parts = []
    if hi >= 0:
        parts.append(int_range_regex(max(lo, 0), hi))
    if lo < 0:
        neg_hi = min(hi, -1)
        parts.append("-" + int_range_regex(-neg_hi, -lo))
    return "(" + "|".join(parts) + ")" if len(parts) > 1 else parts[0]


def _nonneg_num_parts(lo: float, hi: float) -> list[str]:
    """Patterns for `intpart(.frac)?` values in [lo, hi] with 0 <= lo.

    Sound subset: values whose integer part falls in a partially-covered
    integer (e.g. [0.5, 1) when lo=0.5) are omitted rather than over-matched.
    """
    plo = int(lo) if float(lo).is_integer() else int(math.floor(lo)) + 1
    plo = max(0, plo)
    fhi = int(math.floor(hi))
    parts = []
    if fhi - 1 >= plo:
        parts.append(int_range_regex(plo, fhi - 1) + FRAC)
    if fhi >= plo:
        # top integer: free fraction would overshoot; allow .0* only when hi
        # is integral, bare integer otherwise
        parts.append(int_range_regex(fhi, fhi) + (FRAC0 if float(hi).is_integer() else ""))
    return parts


def _num_regex(minimum: float | None, maximum: float | None) -> str:
    if minimum is None and maximum is None:
        return r"(-?(0|[1-9]\d{0,8})(\.\d{1,6})?)"
    lo = float(-_UNBOUNDED) if minimum is None else float(minimum)
    hi = float(_UNBOUNDED) if maximum is None else float(maximum)
    if lo > hi:
        raise ValueError(f"empty number range [{minimum}, {maximum}]")
    parts: list[str] = []
    if hi >= 0:
        parts.extend(_nonneg_num_parts(max(lo, 0.0), hi))
    if lo < 0:
        parts.extend("-" + p for p in _nonneg_num_parts(max(0.0, -hi), -lo))
    if not parts:
        raise ValueError(f"unrepresentable number range [{minimum}, {maximum}]")
    return "(" + "|".join(parts) + ")"


def _escape_literal(s: str) -> str:
    out = []
    for ch in s:
        if ch in r"\.[](){}|*+?-":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def schema_to_regex(
    schema: dict[str, Any],
    overrides: dict[str, str] | None = None,
    max_free_pairs: int = 4,
) -> str:
    """Compile a JSON schema dict (with $defs) to a regex string.

    ``overrides`` maps property names to value regexes (applied wherever the
    property appears).
    """
    defs = schema.get("$defs", {})
    overrides = overrides or {}

    def resolve(node: dict[str, Any]) -> dict[str, Any]:
        while "$ref" in node:
            name = node["$ref"].split("/")[-1]
            node = defs[name]
        return node

    def compile_node(node: dict[str, Any]) -> str:
        node = resolve(node)

        if "enum" in node:
            opts = "|".join('"' + _escape_literal(str(v)) + '"' for v in node["enum"])
            return f"({opts})"
        if "const" in node:
            return '"' + _escape_literal(str(node["const"])) + '"'

        if "anyOf" in node:
            parts = [compile_node(opt) for opt in node["anyOf"]]
            # dedupe (e.g. int|float both become number-ish patterns)
            seen: list[str] = []
            for p in parts:
                if p not in seen:
                    seen.append(p)
            return "(" + "|".join(seen) + ")"

        t = node.get("type")
        if t == "null":
            return NULL
        if t == "boolean":
            return BOOL
        if t == "integer":
            lo, hi = node.get("minimum"), node.get("maximum")
            if "exclusiveMinimum" in node:
                lo = node["exclusiveMinimum"] + 1
            if "exclusiveMaximum" in node:
                hi = node["exclusiveMaximum"] - 1
            return _int_regex(lo, hi)
        if t == "number":
            lo, hi = node.get("minimum"), node.get("maximum")
            # exclusive float bounds: nudge by the smallest emittable step
            if "exclusiveMinimum" in node:
                lo = node["exclusiveMinimum"] + 1e-6
            if "exclusiveMaximum" in node:
                hi = node["exclusiveMaximum"] - 1e-6
            return _num_regex(lo, hi)
        if t == "string":
            return _string_regex(node.get("maxLength"))
        if t == "array":
            item = compile_node(node.get("items", {"type": "string"}))
            max_items = int(node.get("maxItems", 8))
            min_items = int(node.get("minItems", 0))
            if max_items <= 0 or max_items < min_items:
                return r"\[\]"
            body = item
            if min_items > 1:
                body += "(," + item + r"){%d}" % (min_items - 1)
            if max_items > max(min_items, 1):
                body += "(," + item + r"){0,%d}" % (max_items - max(min_items, 1))
            if min_items == 0:
                return r"\[(" + body + r")?\]"
            return r"\[" + body + r"\]"
        if t == "object":
            props = node.get("properties")
            if props:
                parts = []
                for name, sub in props.items():
                    if name in overrides:
                        val = overrides[name]
                    else:
                        val = compile_node(sub)
                    parts.append(f'"{_escape_literal(name)}":' + val)
                return r"\{" + ",".join(parts) + r"\}"
            ap = node.get("additionalProperties")
            if isinstance(ap, dict):
                val = compile_node(ap)
                pair = KEY + ":" + val
                body = pair + "(," + pair + r"){0,%d}" % (max_free_pairs - 1)
                return r"\{(" + body + r")?\}"
            return r"\{\}"

        # untyped (pydantic's Any): permit scalar JSON values
        return "(" + "|".join([STRING, BOOL, NULL, r"(-?(0|[1-9]\d{0,8})(\.\d{1,6})?)"]) + ")"

    return compile_node(schema)
