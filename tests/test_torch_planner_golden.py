"""The planner-distilled brain on the golden dialogs, against JAX's.

``tpu_voice_agent_torch/data/planner_golden.json`` holds the plan token ids
of the 6 ``GOLDEN_DIALOGS`` (every turn, session ids ``golden-dlg-<i>``) as
the JAX package's ``BRAIN_BACKEND=planner-distilled`` brain decodes them on
the in-repo fp32 checkpoint (its sp mesh over the 8 virtual CPU devices), and
whether JAX's planner under ``kernels="pallas"`` (interpret mode) decodes the
same ids as under its default ``"xla"``. Where the two differ, the file keeps
the Pallas ids, which the port's kernels mirror. The tests re-derive the
file from JAX on every run (so it cannot drift) and hold the port's
``planner-distilled`` brain to it token for token; ``chip_smoke.py``'s
planner phase holds the card to the same file.

Regenerate it (JAX on the CPU, ~1 min with the Pallas comparison):

    JAX_PLATFORMS=cpu python tests/test_torch_planner_golden.py --write
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:  # conftest's, when run alone
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402
import torch  # noqa: E402

from tpu_voice_agent_torch import PACKAGE_DIR  # noqa: E402
from tpu_voice_agent_torch.evals.golden import GOLDEN_DIALOGS, score_parser_dialogs  # noqa: E402

GOLDEN = PACKAGE_DIR / "data" / "planner_golden.json"
ENV = {"BRAIN_BACKEND": "planner-distilled", "BRAIN_DEVICE": "cpu"}
UNSET = ("BRAIN_MODEL", "BRAIN_SP", "BRAIN_PAGED", "BRAIN_QUANT", "BRAIN_MOE", "SPEC_ENABLE",
         "BRAIN_PLANNER_HBM_MB", "BRAIN_PLANNER_PARK_MB")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A tiny model: intra-op threads buy nothing under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded(parser):
    """Wrap the parser's plan gather so every plan's (text, ids) is kept."""
    plans = []
    inner = parser._gather.plan

    def plan(sess, max_new):
        out = inner(sess, max_new)
        plans.append(list(out[1]))
        return out

    parser._gather.plan = plan
    return plans


def run_dialogs(parser) -> list[list[dict]]:
    """Every dialog's turns in order, one session each: per turn the plan
    ids and the answer (the response dict, or the error kind)."""
    plans = _recorded(parser)
    out = []
    for di, dlg in enumerate(GOLDEN_DIALOGS):
        turns = []
        for text in dlg.turns:
            n0 = len(plans)
            try:
                resp = parser.parse(text, {}, session_id=f"golden-dlg-{di}")
                answer = resp if isinstance(resp, dict) else resp.model_dump(mode="json")
            except Exception as e:  # noqa: BLE001 - both packages' ParserError
                answer = {"error": getattr(e, "kind", type(e).__name__)}
            turns.append({"text": text, "token_ids": plans[n0] if len(plans) > n0 else [],
                          "answer": answer})
        out.append(turns)
    return out


def jax_dialogs(kernels: str = "xla") -> list[list[dict]]:
    from tpu_voice_agent.services import brain as jbrain

    saved = {k: os.environ.get(k) for k in (*ENV, *UNSET)}
    os.environ.update(ENV)
    for k in UNSET:
        os.environ.pop(k, None)
    try:
        parser = jbrain.make_parser_from_env()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    parser.planner.kernels = kernels
    return run_dialogs(parser)


def write_data() -> dict:
    xla = jax_dialogs("xla")
    pallas = jax_dialogs("pallas")
    same = [[t["token_ids"] for t in d] for d in xla] == [
        [t["token_ids"] for t in d] for d in pallas]
    data = {"source": "tpu_voice_agent BRAIN_BACKEND=planner-distilled, "
                      "checkpoints/intent-tiny-distilled, fp32, sp 8 (virtual CPU devices)",
            "kernels": "xla" if same else "pallas", "pallas_equals_xla": same,
            "dialogs": xla if same else pallas}
    GOLDEN.write_text(json.dumps(data, indent=1) + "\n")
    return data


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.fixture(scope="module")
def port_parser(monkeypatch_module):
    from tpu_voice_agent_torch.services import brain

    for k, v in ENV.items():
        monkeypatch_module.setenv(k, v)
    for k in UNSET:
        monkeypatch_module.delenv(k, raising=False)
    return brain.make_parser_from_env()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_the_recording_is_what_jax_decodes(golden):
    """Re-derived from JAX's planner-distilled brain on every run, under the
    kernels the file names."""
    assert run_ids(jax_dialogs(golden["kernels"])) == run_ids(golden["dialogs"])
    assert golden["kernels"] == ("xla" if golden["pallas_equals_xla"] else "pallas")


def run_ids(dialogs) -> list[list[list[int]]]:
    return [[t["token_ids"] for t in d] for d in dialogs]


def test_port_planner_distilled_decodes_the_recording(golden, port_parser):
    got = run_dialogs(port_parser)
    assert run_ids(got) == run_ids(golden["dialogs"])
    assert [[t["answer"] for t in d] for d in got] == [
        [t["answer"] for t in d] for d in golden["dialogs"]]
    assert all(t["token_ids"] for d in got for t in d)


def test_golden_dialog_scores_on_the_port(golden, port_parser):
    """``score_parser_dialogs(session=True)`` on the port's brain, fresh
    sessions: the score of the recorded final answers."""
    from tpu_voice_agent_torch.evals.golden import GoldenCase, score_case

    port_parser._sessions.clear()
    port_parser._parked.clear()
    hits, args, errors = 0, 0.0, 0
    for dlg, turns in zip(GOLDEN_DIALOGS, golden["dialogs"]):
        if any("error" in t["answer"] for t in turns):
            errors += 1
            continue
        tm, a = score_case(GoldenCase(dlg.turns[-1], dlg.expected_types, facts=dlg.facts),
                           turns[-1]["answer"])
        hits, args = hits + tm, args + a
    assert score_parser_dialogs(port_parser, session=True) == {
        "dialogs": 6, "errors": errors, "type_accuracy": hits / 6, "args_score": args / 6}


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit(__doc__)
    d = write_data()
    print(f"wrote {GOLDEN}: kernels {d['kernels']}, pallas_equals_xla {d['pallas_equals_xla']}")
