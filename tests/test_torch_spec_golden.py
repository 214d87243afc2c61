"""The distilled intent checkpoint under speculative decoding, against the
recorded JAX parses.

Speculative greedy output is plain greedy output by construction, and the
distilled engine runs with fast-forward off, so no new recording is needed:
the single-slot spec engine and the 15-slot paged spec engine (bf16 pool)
must reproduce ``data/intent_golden.json`` token for token, and the int8 and
int4 pools ``data/intent_golden_kvquant.json`` for their tier. Beside them,
the self-draft (the checkpoint as its own draft model) must accept more
than 0.9 of its drafts at more than 2 tokens per verify step, the bar of the
JAX package's paged self-draft test. ``chip_smoke.py``'s ``spec_golden``
phase holds the card to the same files.
"""

import dataclasses

import pytest
import torch

from tpu_voice_agent_torch import distilled
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.serve.spec import DraftModelDrafter, SpecConfig, SpecDecoder

SPEC = SpecConfig(k=4, drafter="fsm,prompt")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: intra-op threads buy nothing, and under the
    suite's parallel workers every process's threads contend for the same
    cores (a file that takes 20 s alone took 15 minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return distilled.load_distilled(device="cpu")


def test_single_slot_spec_parses_equal_the_recording(weights):
    parser = distilled.intent_engine_from(*weights, device="cpu", spec=SPEC)
    eng = parser.engine
    for rec in distilled.golden_records():
        resp = parser.parse(rec["text"], rec["context"])
        res = parser.last_result
        assert res.token_ids == rec["token_ids"], rec["text"]
        assert resp == rec["response"] and res.forwards < res.steps
    s = eng.spec.stats()
    assert s["accepted"] > 0 and s["tokens_per_step"] > 1.0


def test_self_draft_parses_equal_the_recording(weights):
    parser = distilled.intent_engine_from(*weights, device="cpu")
    eng = parser.engine
    eng.spec = SpecDecoder(eng, SpecConfig(k=4), drafter=DraftModelDrafter(
        eng, 4, cfg=eng.cfg, params=eng.params))
    for rec in distilled.golden_records():
        parser.parse(rec["text"], rec["context"])
        assert parser.last_result.token_ids == rec["token_ids"], rec["text"]
    s = eng.spec.stats()
    assert s["accept_rate"] > 0.9 and s["tokens_per_step"] > 2.0


@pytest.mark.parametrize("tier", ["off", "int8", "int4"])
def test_paged_spec_parses_equal_the_recording(weights, tier):
    """15 slots, every golden utterance at once, as chip_smoke.py's
    batch_golden and kvquant_golden phases set the engine up."""
    cfg, params = weights
    recs = (distilled.golden_records() if tier == "off"
            else distilled.kvquant_golden_records()["tiers"][tier])
    eng = PagedDecodeEngine(cfg=dataclasses.replace(cfg, max_seq_len=512), max_len=512,
                            prefill_buckets=(64, 128), batch_slots=15, kv_quant=tier,
                            init_weights=False, device="cpu", spec=SPEC)
    eng.load_params(params)
    res = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=300).generate_many(
        [distilled.distilled_prompt(r["text"], r["context"]) for r in recs])
    for rec, r in zip(recs, res):
        assert r.error is None and r.finished
        assert r.token_ids == rec["token_ids"], (tier, rec["text"])
        assert 0 < r.forwards < r.steps
    assert eng.allocator.blocks_in_use == 0
