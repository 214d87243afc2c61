"""The port's rule backend (the default ``BRAIN_BACKEND``) and its
``x-deadline-ms`` gate, held against the JAX service.

- ``RuleBasedParser``: every branch's utterances through the JAX class
  (``model_dump()``) and the port's (the validated dict): equal JSON.
- The deadline gate: the same requests to the JAX brain app (aiohttp on a
  socket, the rule parser behind it) and to the port's ``BrainApp``. A
  budget that has run out gets 503 ``{"error": "overloaded", "detail":
  "deadline_expired"}`` with ``Retry-After: 0`` from both; a generous
  budget, a value that is no number, and no header at all get a 200 with
  the same body.
- An unset ``BRAIN_BACKEND`` boots the rule parser and builds no engine; the
  engine knobs set beside it are logged and ignored, as the JAX service does.
"""

import json
import logging

import httpx
import pytest

from tests.http_helper import AppServer
from tpu_voice_agent.services.brain import RuleBasedParser as JaxRuleBasedParser
from tpu_voice_agent.services.brain import build_app
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.services import brain
from tpu_voice_agent_torch.utils.compilewatch import get_compile_watcher
from tpu_voice_agent_torch.utils.steplog import get_steplog
from tpu_voice_agent_torch.utils.tracing import get_metrics

# every branch of the parser, in its order, and the ones that fall through
UTTERANCES = [
    "search for wireless headphones",  # search
    "Find cheap flights to Lisbon!",  # search, "find"
    "look for the nearest pharmacy.",  # search, "look for"
    "open example.com",  # navigate, scheme added
    "please navigate to https://news.ycombinator.com/newest",  # navigate, with a scheme
    "go to docs.python.org",  # navigate, "go to", .org
    "upload my resume and submit the form",  # upload + submit click
    "upload the photo",  # upload alone
    "sort these by price",  # sort asc
    "sort by rating from high to low",  # sort desc
    "sorted by date descending",  # sort desc, "sorted"
    "open the second result",  # ordinal result
    "open the 4th link",  # numeric result
    "open the 12 item",  # numeric result without a suffix
    "click on the sign in button",  # click
    "click checkout",  # click, no article
    "take a screenshot",  # screenshot
    "scroll up a bit",  # scroll up
    "scroll",  # scroll down
    "go back",  # back
    "back to the previous page",  # back, the bare word
    "extract the pricing table",  # extract_table
    "summarize this article",  # summarize
    "give me a summary",  # summarize, "summary"
    "cancel that",  # cancel
    "florble the wug",  # unknown, low confidence, follow-up
    "open the pod bay doors",  # unknown: "open" with no url or result
]


@pytest.mark.parametrize("text", UTTERANCES)
def test_rule_parser_matches_the_jax_class(text):
    ours = brain.RuleBasedParser().parse(text, {})
    theirs = JaxRuleBasedParser().parse(text, {}).model_dump()
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)


def test_rule_parser_covers_every_branch():
    kinds = {tuple(i["type"] for i in brain.RuleBasedParser().parse(t, {})["intents"])
             for t in UTTERANCES}
    assert kinds == {("search",), ("navigate",), ("upload", "click"), ("upload",), ("sort",),
                     ("click",), ("screenshot",), ("scroll",), ("back",), ("extract_table",),
                     ("summarize",), ("cancel",), ("unknown",)}


@pytest.fixture(scope="module")
def jax_rule_server():
    with AppServer(build_app(JaxRuleBasedParser())) as srv:
        yield srv


@pytest.mark.parametrize("budget,status", [
    ("0", 503), ("-25", 503), ("60000", 200), ("soon", 200), (None, 200),
])
def test_deadline_gate_matches_the_jax_brain(jax_rule_server, budget, status):
    body = {"text": "search for wireless headphones", "context": {}}
    headers = {} if budget is None else {"x-deadline-ms": budget}
    r = httpx.post(jax_rule_server.url + "/parse", json=body, headers=headers, timeout=30)
    got, out, out_headers = brain.BrainApp(brain.RuleBasedParser()).parse(
        json.dumps(body).encode(), {"X-Deadline-Ms": budget} if budget is not None else None)
    assert (r.status_code, got) == (status, status)
    assert out == r.json()
    if status == 503:
        assert out == {"error": "overloaded", "detail": "deadline_expired"}
        assert out_headers["Retry-After"] == r.headers["Retry-After"] == "0"
    else:
        assert "Retry-After" not in out_headers


def test_deadline_gate_answers_before_any_decode():
    class Refusing:
        def parse(self, text, context):
            raise AssertionError("decoded past an expired deadline")

    status, body, headers = brain.BrainApp(Refusing()).parse(
        b'{"text": "go back"}', {"x-deadline-ms": "0", "x-trace-id": "t1"})
    assert (status, body["detail"], headers) == (
        503, "deadline_expired", {"x-trace-id": "t1", "Retry-After": "0"})


def test_unset_backend_boots_the_rule_parser(monkeypatch, caplog):
    for name in ("BRAIN_BACKEND", "BRAIN_DEVICE", "SPEC_ENABLE", "BRAIN_MODEL",
                 "ENGINE_STALL_S", "BRAIN_ROLE"):
        monkeypatch.delenv(name, raising=False)
    built = []
    for cls in (DecodeEngine, PagedDecodeEngine):
        monkeypatch.setattr(cls, "__init__", lambda *a, **k: built.append(1))
    monkeypatch.setenv("BRAIN_PAGED", "1")
    monkeypatch.setenv("BRAIN_QUANT", "int8")
    monkeypatch.setenv("BRAIN_MOE", "grouped")
    with caplog.at_level(logging.WARNING, logger="tpu_voice_agent_torch.brain"):
        parser = brain.make_parser_from_env()
    assert isinstance(parser, brain.RuleBasedParser) and not built
    warned = [r.getMessage() for r in caplog.records]
    assert warned == [f"{k} is not supported by the rule backend; ignoring"
                      for k in ("BRAIN_PAGED", "BRAIN_QUANT", "BRAIN_MOE")]
    app = brain.BrainApp(parser)
    get_steplog().clear()  # no step recorded: no last_step
    status, body, headers = app.health()
    # the compile sentinel and the HBM gauges are process-global, as in JAX:
    # /health reports them as they stand
    assert body.pop("compile_sentinel") == get_compile_watcher().state()
    hbm = {k: v for k, v in get_metrics().gauges().items() if k.startswith("hbm.")}
    assert body.pop("hbm", {}) == hbm
    # the pressure block is the router's shed signal (JAX's, for the same backend)
    assert (status, body, headers) == (
        200, {"ok": True, "service": "brain", "slo": "ok", "quality": {"slo": "ok"},
              "inflight": 0, "max_inflight": 32, "role": "both", "disagg": False,
              "pressure": {"score": 0.0, "slo": "ok", "admission": 0.0}}, {})
    status, body, _ = app.parse(b'{"text": "take a screenshot"}')
    assert status == 200 and body["intents"][0]["type"] == "screenshot"
    # distilled is served since the trained brain boots from the environment,
    # and the planner backends since the sp ring: planner-distilled answers
    # the same utterance within a session
    monkeypatch.setenv("BRAIN_BACKEND", "planner-distilled")
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    planner = brain.make_parser_from_env()
    assert isinstance(planner, brain.PlannerParser) and planner.planner.sp == 1
    status, body, _ = brain.BrainApp(planner).parse(
        b'{"text": "take a screenshot", "session_id": "s1"}')
    assert status == 200 and body["intents"][0]["type"] == "screenshot"
    assert planner.session_count() == 1
