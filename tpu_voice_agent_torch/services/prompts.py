"""Intent-parsing prompt: system instructions + few-shot exemplars.

Capability parity with the reference brain prompt (apps/brain/src/server.ts:
13-82): a system contract plus five exemplars covering (1) plain search,
(2) a context-dependent follow-up ("open the second result"), (3) sorting,
(4) a risky upload+submit that requires confirmation, and (5) a multi-intent
search -> wait_for -> extract_table chain. Wording is original; only the
*coverage* mirrors the reference. The few-shot set doubles as the tokenizer
training corpus and the golden-file eval set (SURVEY.md §4).
"""

from __future__ import annotations

import json

SYSTEM_PROMPT = """\
You convert spoken browser commands into a strict JSON plan.
Output exactly one JSON object with fields: version, intents, context_updates,
confidence, tts_summary, follow_up_question. Each intent has: type, target,
args, priority, requires_confirmation, timeout_ms, retries.
Intent types: search, navigate, click, type, extract, extract_table, sort,
filter, scroll, back, forward, select, wait_for, upload, screenshot,
summarize, confirm, cancel, unknown.
Rules:
- Use the session context to resolve references like "the second result".
- Mark upload and any destructive or irreversible step requires_confirmation=true.
- Keep confidence honest; if the command is ambiguous, ask a follow_up_question.
- Respond with compact JSON only, no prose.
"""


def _resp(intents: list[dict], ctx: dict | None = None, conf: float = 0.9,
          tts: str | None = None, follow_up: str | None = None) -> dict:
    full = []
    for it in intents:
        full.append(
            {
                "type": it["type"],
                "target": it.get("target"),
                "args": it.get("args", {}),
                "priority": it.get("priority", 1),
                "requires_confirmation": it.get("requires_confirmation", False),
                "timeout_ms": it.get("timeout_ms", 15000),
                "retries": it.get("retries", 0),
            }
        )
    return {
        "version": "1.0",
        "intents": full,
        "context_updates": ctx or {},
        "confidence": conf,
        "tts_summary": tts,
        "follow_up_question": follow_up,
    }


FEWSHOTS: list[tuple[dict, dict]] = [
    (
        {"text": "search for wireless headphones", "context": {}},
        _resp(
            [{"type": "search", "args": {"query": "wireless headphones"}}],
            ctx={"last_query": "wireless headphones"},
            conf=0.95,
            tts="Searching for wireless headphones",
        ),
    ),
    (
        {"text": "open the second result", "context": {"last_query": "wireless headphones"}},
        _resp(
            [
                {
                    "type": "click",
                    "target": {"strategy": "auto", "value": None, "role": "link", "name": None},
                    "args": {"index": 2},
                }
            ],
            conf=0.85,
            tts="Opening the second result",
        ),
    ),
    (
        {"text": "sort these by price from low to high", "context": {"last_query": "wireless headphones"}},
        _resp(
            [{"type": "sort", "args": {"field": "price", "direction": "asc"}}],
            conf=0.9,
            tts="Sorting by price, low to high",
        ),
    ),
    (
        {"text": "upload my resume and submit the form", "context": {}},
        _resp(
            [
                {"type": "upload", "args": {"fileRef": None}, "requires_confirmation": True},
                {"type": "click", "target": {"strategy": "text", "value": "Submit", "role": None, "name": None},
                 "requires_confirmation": True},
            ],
            conf=0.88,
            tts="I will upload your resume and submit the form after you confirm",
        ),
    ),
    (
        {"text": "search for 4k monitors, wait for the results and extract the table",
         "context": {}},
        _resp(
            [
                {"type": "search", "args": {"query": "4k monitors"}},
                {"type": "wait_for", "target": {"strategy": "css", "value": ".results", "role": None, "name": None},
                 "timeout_ms": 10000},
                {"type": "extract_table", "args": {"format": "csv"}},
            ],
            ctx={"last_query": "4k monitors"},
            conf=0.92,
            tts="Searching, then extracting the results table",
        ),
    ),
]

# Extra utterances for tokenizer BPE training (never shown to the model).
TOKENIZER_EXTRA_CORPUS = [
    "navigate to example dot com and take a screenshot",
    "scroll down two pages then go back",
    "click the add to cart button on the first item",
    "filter results under one hundred dollars",
    "type my email address into the newsletter box",
    "select the large size from the dropdown menu",
    "summarize this page for me please",
    "cancel that and close the dialog window",
    "wait for the checkout button then press it",
    "extract the product names and prices as a table",
    "what is on this page right now",
    "open the settings menu and turn on dark mode",
]


def fewshot_messages() -> list[dict]:
    """Chat messages for the parse prompt (system + user/assistant pairs)."""
    msgs = [{"role": "system", "content": SYSTEM_PROMPT}]
    for req, resp in FEWSHOTS:
        msgs.append({"role": "user", "content": json.dumps(req, separators=(",", ":"))})
        msgs.append({"role": "assistant", "content": json.dumps(resp, separators=(",", ":"))})
    return msgs


def prompt_prefix() -> str:
    """The request-invariant prompt head (system + few-shots + user tag).
    Identical for every /parse call, which makes it the shared-prefix cache
    unit: the engine prefills it once and per-request prefill touches only
    the suffix returned by ``render_prompt`` minus this string."""
    parts = [f"<|{m['role']}|>\n{m['content']}" for m in fewshot_messages()]
    return "\n".join(parts) + "\n<|user|>\n"


def render_prompt(text: str, context: dict) -> str:
    """Flatten chat messages into the plain-text prompt format used by the
    in-tree decoder (no chat template dependency)."""
    user = json.dumps({"text": text, "context": context}, separators=(",", ":"))
    return prompt_prefix() + user + "\n<|assistant|>\n"


def corpus_for_tokenizer() -> list[str]:
    out = [SYSTEM_PROMPT]
    for req, resp in FEWSHOTS:
        out.append(json.dumps(req, separators=(",", ":")))
        out.append(json.dumps(resp, separators=(",", ":")))
    out.extend(TOKENIZER_EXTRA_CORPUS)
    return out
