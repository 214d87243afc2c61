"""The port's grammar and schema against the JAX package's, array for array.

Both packages build the intent grammar from scratch (the port reads the
ParseResponse schema from its committed JSON file, the JAX package from
pydantic), so every table the decode loop reads must come out identical:
the tokenizer's byte pieces, the compressed FSM table and column ids, the
dense mask, and the fast-forward chains at width 8.
"""

import json

import numpy as np
import pytest

from tpu_voice_agent.grammar import build_intent_fsm as j_build
from tpu_voice_agent.grammar import intent_grammar as j_grammar
from tpu_voice_agent.grammar.fsm import sample_dfa
from tpu_voice_agent.schemas import ParseResponse
from tpu_voice_agent.schemas import parse_response_from_json as j_parse
from tpu_voice_agent.services.prompts import FEWSHOTS
from tpu_voice_agent_torch import schemas
from tpu_voice_agent_torch.grammar import build_intent_fsm, intent_grammar


@pytest.fixture(scope="module")
def both():
    return j_build(), build_intent_fsm()


def test_schema_file_equals_pydantic():
    assert schemas.parse_response_schema() == ParseResponse.model_json_schema()


def test_regex_is_string_equal():
    assert intent_grammar.intent_regex() == j_grammar.intent_regex()


def test_tokenizer_is_identical(both):
    (jt, _), (tt, _) = both
    assert tt.byte_pieces() == jt.byte_pieces()
    assert (tt.vocab_size, tt.eos_id, tt.pad_id, tt.bos_id) == (
        jt.vocab_size, jt.eos_id, jt.pad_id, jt.bos_id)


def test_fsm_tables_are_identical(both):
    (_, jf), (_, tf) = both
    assert (tf.start, tf.num_states, tf.num_classes) == (jf.start, jf.num_states, jf.num_classes)
    np.testing.assert_array_equal(tf.table, jf.table)
    np.testing.assert_array_equal(tf.col_id, jf.col_id)
    np.testing.assert_array_equal(tf.mask, jf.mask)
    for a, b in zip(tf.forced_tables(8), jf.forced_tables(8)):
        np.testing.assert_array_equal(a, b)


def test_device_tables_carry_the_dense_mask(both):
    """S * V is under the dense limit, so the fused kernel's mask exists
    (row-major, as the kernel reads it) and the ff chains attach."""
    (_, jf), (_, tf) = both
    dt = tf.device_tables(ff_width=8)
    assert dt.dense_mask is not None and dt.dense_mask.is_contiguous()
    np.testing.assert_array_equal(dt.dense_mask.numpy(), jf.mask)
    np.testing.assert_array_equal(dt.ff_tokens.numpy(), jf.forced_tables(8)[0])


def _texts():
    """Grammar-legal payloads: random DFA walks plus the few-shot answers."""
    from tpu_voice_agent_torch.grammar.intent_grammar import intent_dfa

    rng = np.random.default_rng(0)
    dfa = intent_dfa()
    texts = [sample_dfa(dfa, rng).decode("utf-8", "replace") for _ in range(12)]
    texts += [json.dumps(resp, separators=(",", ":")) for _req, resp in FEWSHOTS]
    return texts


def test_response_dict_equals_model_dump():
    """The port's /parse body is ParseResponse.model_dump() on the same text."""
    n_ok = 0
    for text in _texts():
        model, _ = j_parse(text)
        resp, err = schemas.parse_response_from_json(text)
        if model is None:
            assert resp is None and err
            continue
        assert resp == model.model_dump(), text
        n_ok += 1
    assert n_ok >= 10


@pytest.mark.parametrize("obj", [
    {"intents": []},  # confidence missing
    {"confidence": 2.0},
    {"confidence": 0.5, "bogus": 1},
    {"confidence": 0.5, "intents": [{"type": "fly"}]},
    {"confidence": 0.5, "intents": [{"type": "click", "priority": 9}]},
])
def test_invalid_payloads_are_refused_by_both(obj):
    text = json.dumps(obj)
    assert j_parse(text)[0] is None
    assert schemas.parse_response_from_json(text)[0] is None
