"""The golden intent cases and the quantized-KV accuracy differential.

Port of the parts of ``tpu_voice_agent/evals/golden.py`` that the KV_QUANT
tier's accuracy gate and the golden-replay canary need: ``GoldenCase``,
``GOLDEN_INTENT_CASES`` (the held-out utterances with their expected intent
types and argument facts), ``score_case``, ``intent_types`` and
``kv_quant_differential``; and the multi-turn dialogs, ``GOLDEN_DIALOGS``
with ``score_parser_dialogs``, which the session-keyed planner backend is
scored on. The single-turn parser scoring (``score_parser``) is not ported.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class GoldenCase:
    text: str
    expected_types: tuple[str, ...]
    context: dict = field(default_factory=dict)
    # facts: (intent_index, dotted path under that intent, expected value)
    facts: tuple[tuple[int, str, Any], ...] = ()


GOLDEN_INTENT_CASES: list[GoldenCase] = [
    GoldenCase(
        "search for mechanical keyboards",
        ("search",),
        facts=((0, "args.query", "mechanical keyboard"),),
    ),
    GoldenCase(
        "find waterproof hiking boots",
        ("search",),
        facts=((0, "args.query", "hiking boots"),),
    ),
    GoldenCase(
        "open the third result",
        ("click",),
        context={"last_query": "mechanical keyboards"},
        facts=((0, "args.index", 3),),
    ),
    GoldenCase(
        "sort these by price from high to low",
        ("sort",),
        context={"last_query": "laptops"},
        facts=((0, "args.field", "price"), (0, "args.direction", "desc")),
    ),
    GoldenCase(
        "upload my cover letter and submit it",
        ("upload", "click"),
        facts=(
            (0, "requires_confirmation", True),
            (1, "requires_confirmation", True),
        ),
    ),
    GoldenCase(
        "go back",
        ("back",),
    ),
    GoldenCase(
        "scroll down",
        ("scroll",),
        facts=((0, "args.direction", "down"),),
    ),
    GoldenCase(
        "take a screenshot of this page",
        ("screenshot",),
    ),
    GoldenCase(
        "extract the table as csv",
        ("extract_table",),
        facts=((0, "args.format", "csv"),),
    ),
    GoldenCase(
        "summarize this page",
        ("summarize",),
    ),
    GoldenCase(
        "cancel that",
        ("cancel",),
    ),
    GoldenCase(
        "click the checkout button",
        ("click",),
        facts=((0, "target.value", "checkout"),),
    ),
    GoldenCase(
        "search for usb c chargers and sort by price low to high",
        ("search", "sort"),
        facts=(
            (0, "args.query", "usb c charger"),
            (1, "args.direction", "asc"),
        ),
    ),
    GoldenCase(
        "open the first link",
        ("click",),
        context={"last_query": "usb c chargers"},
        facts=((0, "args.index", 1),),
    ),
    GoldenCase(
        "navigate to example.com",
        ("navigate",),
        facts=((0, "args.url", "example.com"),),
    ),
]


def _dig(obj: Any, path: str) -> Any:
    cur = obj
    for part in path.split("."):
        cur = cur.get(part) if isinstance(cur, dict) else getattr(cur, part, None)
        if cur is None:
            return None
    return cur


def _fact_holds(intent: Any, path: str, want: Any) -> bool:
    got = _dig(intent, path)
    if isinstance(want, str):
        return isinstance(got, str) and want.lower() in got.lower()
    if isinstance(want, bool):
        return got is want
    return got == want


def score_case(case: GoldenCase, resp: Any) -> tuple[bool, float]:
    """``resp``: a ParseResponse dict (or anything with ``intents``).
    Returns (type_match, args_score in [0, 1])."""
    intents = (resp.get("intents") if isinstance(resp, dict)
               else getattr(resp, "intents", None)) or []
    types = tuple(i.get("type") if isinstance(i, dict) else getattr(i, "type", None)
                  for i in intents)
    type_match = types == case.expected_types
    if not case.facts:
        return type_match, 1.0 if type_match else 0.0
    held = sum(1 for idx, path, want in case.facts
               if idx < len(intents) and _fact_holds(intents[idx], path, want))
    return type_match, held / len(case.facts)


@dataclass(frozen=True)
class GoldenDialog:
    """A multi-turn case: earlier turns set up context (a search, a page),
    the LAST turn is scored."""
    turns: tuple[str, ...]
    expected_types: tuple[str, ...]  # for the final turn's plan
    facts: tuple[tuple[int, str, Any], ...] = ()


GOLDEN_DIALOGS: list[GoldenDialog] = [
    GoldenDialog(
        ("search for ergonomic drafting stools", "open the second result"),
        ("click",),
        facts=((0, "args.index", 2),),
    ),
    GoldenDialog(
        ("find noise cancelling earmuffs", "sort these by price from low to high"),
        ("sort",),
        facts=((0, "args.field", "price"), (0, "args.direction", "asc")),
    ),
    GoldenDialog(
        ("search for portable projectors", "open the fourth link"),
        ("click",),
        facts=((0, "args.index", 4),),
    ),
    GoldenDialog(
        ("search for suede messenger bags", "take a screenshot of this page"),
        ("screenshot",),
    ),
    GoldenDialog(
        ("find budget camcorders", "open the first result and scroll down"),
        ("click", "scroll"),
        facts=((0, "args.index", 1), (1, "args.direction", "down")),
    ),
    GoldenDialog(
        ("search for copper tea kettles",
         "sort by rating high to low",
         "extract the table as csv"),
        ("extract_table",),
        facts=((0, "args.format", "csv"),),
    ),
]


def score_parser_dialogs(parser, dialogs: list[GoldenDialog] | None = None,
                         session: bool = False) -> dict:
    """Run each dialog's turns in order and score the FINAL turn.

    ``session=False`` threads context as the voice service does for a
    stateless parser (each turn's ``context_updates`` merge into the next
    turn's context); ``session=True`` passes a per-dialog ``session_id``
    (``golden-dlg-<i>``) so a session-keyed parser carries its own
    transcript. A dialog whose turn raises counts as an error."""
    dialogs = dialogs if dialogs is not None else GOLDEN_DIALOGS
    type_hits = 0
    args_total = 0.0
    errors = 0
    for di, dlg in enumerate(dialogs):
        ctx: dict = {}
        resp = None
        try:
            for turn in dlg.turns:
                if session:
                    resp = parser.parse(turn, {}, session_id=f"golden-dlg-{di}")
                else:
                    resp = parser.parse(turn, dict(ctx))
                    ctx.update((resp.get("context_updates") if isinstance(resp, dict)
                                else getattr(resp, "context_updates", None)) or {})
        except Exception:  # noqa: BLE001 - a failed dialog is scored as an error
            errors += 1
            continue
        tm, ascore = score_case(GoldenCase(dlg.turns[-1], dlg.expected_types,
                                           facts=dlg.facts), resp)
        type_hits += int(tm)
        args_total += ascore
    n = len(dialogs)
    return {"dialogs": n, "errors": errors,
            "type_accuracy": type_hits / n, "args_score": args_total / n}


# ------------------------------------------------------ quantized-KV tiers

_INTENT_TYPE = re.compile(r'"type"\s*:\s*"([a-z_]+)"')


def intent_types(text: str) -> tuple[str, ...]:
    """Intent-type sequence of a grammar-constrained JSON generation (the
    grammar guarantees the shape, so a regex pull is exact)."""
    return tuple(_INTENT_TYPE.findall(text))


def kv_quant_differential(make_engine, cases: list[GoldenCase]) -> dict:
    """The lossy-KV accuracy budget: decode the golden utterances' rendered
    prompts through the continuous batcher once per KV tier and score each
    tier against the KV_QUANT-off baseline:

    - ``token_identical``: the share of cases whose token stream equals the
      baseline's (the int8 bar);
    - ``type_agreement``: the share whose intent-type sequence equals it
      (the int4 floor: a tier may rephrase an argument inside the grammar
      without changing what the executor does);
    - ``grammar_valid``: the share the FSM accepts (1.0 for every tier).

    ``make_engine(kv_quant)`` builds a fresh paged engine per tier on the
    same weights; each case decodes at most 96 new tokens, in chunks of 16.
    The baseline is asked for as the explicit ``"off"`` tier, never None:
    None falls through to ``KV_QUANT`` in the engine, which under
    ``KV_QUANT=int8`` would make the baseline the quantized tier and every
    floor trivially 1.0."""
    from ..serve.scheduler import ContinuousBatcher
    from ..services.prompts import render_prompt

    tiers = ("int8", "int4")
    prompts = [render_prompt(c.text, dict(c.context)) for c in cases]
    runs: dict[str | None, list] = {}
    fsm = None
    for tier in (None, *tiers):
        eng = make_engine(tier or "off")
        fsm = eng.fsm
        res = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=96).generate_many(prompts)
        for r in res:
            if r.error is not None:
                raise AssertionError(f"kv_quant={tier}: {r.error}")
        runs[tier] = res
    base = runs[None]
    n = len(cases)
    out = {"cases": n, "tiers": {}}
    for tier in tiers:
        res = runs[tier]
        out["tiers"][tier] = {
            "token_identical": sum(r.token_ids == b.token_ids for r, b in zip(res, base)) / n,
            "type_agreement": sum(intent_types(r.text) == intent_types(b.text)
                                  for r, b in zip(res, base)) / n,
            "grammar_valid": sum(fsm.walk(r.token_ids) >= 0 for r in res) / n,
        }
    return out
