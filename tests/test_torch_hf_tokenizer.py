"""The port's HF tokenizer and the intent FSM over it, against the JAX package.

The JAX package's ``tests/test_hf_real.py`` tokenizer and FSM cases, on the
port: a byte-level (GPT-2 family) ``tokenizer.json`` with merges trained on
the prompt corpus and added specials, and a SentencePiece-style (Llama-2
family) one with ``▁`` pieces and ``<0xNN>`` byte fallback. The port's ids
must equal JAX's ``HFTokenizer`` over the prompt corpus, and its
``TokenFSM`` tables (``table``, ``col_id``) JAX's ``build_fsm_for`` exactly.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from tpu_voice_agent.grammar import hf_tokenizer as jhft
from tpu_voice_agent.grammar.intent_grammar import build_fsm_for as j_build_fsm_for
from tpu_voice_agent_torch.grammar.fsm import TokenFSM
from tpu_voice_agent_torch.grammar.hf_tokenizer import (
    HFTokenizer,
    _byte_to_unicode,
    _PRETOK,
    load_hf_tokenizer,
)
from tpu_voice_agent_torch.grammar.intent_grammar import build_fsm_for, intent_dfa
from tpu_voice_agent_torch.grammar.tokenizer import Tokenizer
from tpu_voice_agent_torch.services.prompts import corpus_for_tokenizer, render_prompt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs in six worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INTENT_JSON = ('{"version":"1.0","intents":[{"type":"back","target":null,"args":{},'
               '"priority":1,"requires_confirmation":false,"timeout_ms":15000,"retries":0}],'
               '"context_updates":{},"confidence":0.9,"tts_summary":null,'
               '"follow_up_question":null}')


def _train_merges(texts: list[str], n: int) -> list[tuple[str, str]]:
    """BPE merges over byte-unicode symbols (what a GPT-2-family
    tokenizer.json ships in ``merges``)."""
    b2u = _byte_to_unicode()
    words: Counter = Counter()
    for t in texts:
        for m in _PRETOK.finditer(t):
            words[tuple(b2u[b] for b in m.group(0).encode())] += 1
    merges: list[tuple[str, str]] = []
    work = dict(words)
    for _ in range(n):
        pairs: Counter = Counter()
        for w, c in work.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append((a, b))
        new = {}
        for w, c in work.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + c
        work = new
    return merges


CORPUS = [render_prompt("search for wireless headphones", {}),
          render_prompt("open the second result and extract the table", {"last_query": "x"}),
          INTENT_JSON]


@pytest.fixture(scope="module")
def bytelevel_json(tmp_path_factory):
    """A GPT-2-family tokenizer.json: 256 byte symbols, merges trained on
    the prompt corpus, added special bos / eos."""
    merges = _train_merges(CORPUS, 400)
    b2u = _byte_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    n = len(vocab)
    obj = {"model": {"type": "BPE", "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
           "pre_tokenizer": {"type": "ByteLevel"},
           "added_tokens": [{"id": n, "content": "<|begin_of_text|>", "special": True},
                            {"id": n + 1, "content": "<|end_of_text|>", "special": True}]}
    d = tmp_path_factory.mktemp("bl_tok")
    (d / "tokenizer.json").write_text(json.dumps(obj))
    return d / "tokenizer.json"


@pytest.fixture(scope="module")
def sp_json(tmp_path_factory):
    """A Llama-2-family tokenizer.json: ``<unk> <s> </s>``, 256 ``<0xNN>``
    pieces, characters, merges trained on the corpus's ▁-words, and the
    Prepend / Replace normalizer."""
    words: Counter = Counter()
    for text in CORPUS:
        for w in ("▁" + text.replace(" ", "▁")).split("▁"):
            if w:
                words[tuple("▁" + w)] += 1
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for w in words:
        for ch in w:
            if ch != "é":  # one character left to the byte fallback
                vocab.setdefault(ch, len(vocab))
    merges = []
    work = dict(words)
    for _ in range(300):
        pairs: Counter = Counter()
        for w, c in work.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        work = {tuple(_merge(w, a, b)): c for w, c in work.items()}
    for a, b in (("t", "h"), ("th", "e"), ("▁", "the"), ("c", "a"), ("ca", "t"), ("▁", "cat")):
        vocab.setdefault(a + b, len(vocab))
        merges.append((a, b))
    obj = {"model": {"type": "BPE", "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
           "normalizer": {"type": "Sequence", "normalizers": [
               {"type": "Prepend", "prepend": "▁"},
               {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
           "added_tokens": [{"id": i, "content": c, "special": True}
                            for i, c in enumerate(("<unk>", "<s>", "</s>"))]}
    d = tmp_path_factory.mktemp("sp_tok")
    (d / "tokenizer.json").write_text(json.dumps(obj))
    return d / "tokenizer.json"


def _merge(w, a, b):
    out, i = [], 0
    while i < len(w):
        if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(w[i])
            i += 1
    return out


TEXTS = ["search for wireless headphones", INTENT_JSON, "Hello, World! 123",
         "tabs\tand\nnewlines", "caté <s> and </s> inside", "  leading and trailing  "]


# ---------------------------------------------------------------- the tokenizer


def test_bytelevel_roundtrip_and_compression(bytelevel_json):
    tok = load_hf_tokenizer(bytelevel_json)
    assert tok.kind == "byte_level"
    for text in TEXTS[:4]:
        assert tok.decode(tok.encode(text)) == text
    text = render_prompt("search for shoes", {})
    assert len(tok.encode(text)) < 0.6 * len(text.encode())


def test_bytelevel_merge_order_is_rank_based():
    b2u = _byte_to_unicode()
    vocab = {b2u[ord(ch)]: i for i, ch in enumerate("abc")}
    vocab[b2u[ord("a")] + b2u[ord("b")]] = 3
    vocab[b2u[ord("b")] + b2u[ord("c")]] = 4
    vocab["</s>"] = 5
    tok = HFTokenizer(vocab=vocab, kind="byte_level", added={"</s>": 5},
                      merges=[(b2u[ord("b")], b2u[ord("c")]), (b2u[ord("a")], b2u[ord("b")])])
    assert tok.encode("abc") == [0, 4]


def test_bytelevel_specials(bytelevel_json):
    tok = load_hf_tokenizer(bytelevel_json)
    assert tok.id_of("<|begin_of_text|>") == tok.bos_id
    assert tok.id_of("<|end_of_text|>") == tok.eos_id
    assert tok.token_bytes(tok.eos_id) == b""
    ids = tok.encode("hi", bos=True, eos=True)
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert tok.eos_id in tok.encode("a<|end_of_text|>b")
    assert tok.special_ids == {tok.bos_id, tok.eos_id}


def test_sp_roundtrip_merges_and_byte_fallback(sp_json):
    tok = load_hf_tokenizer(sp_json)
    assert tok.kind == "sentencepiece" and (tok.bos_id, tok.eos_id, tok.pad_id) == (1, 2, 0)
    assert tok.decode(tok.encode("the cat")) == "the cat"
    assert tok.id_to_tok[tok.encode("the")[0]] == "▁the"  # the Prepend normalizer's ▁
    ids = tok.encode("caté")  # é is not a piece: <0xC3><0xA9>
    assert tok.decode(ids) == "caté"
    assert tok.id_to_tok[ids[-1]] == "<0xA9>" and tok.token_bytes(ids[-1]) == b"\xa9"


@pytest.mark.parametrize("kind", ["bytelevel", "sp"])
def test_ids_equal_jax_over_the_prompt_corpus(bytelevel_json, sp_json, kind):
    path = bytelevel_json if kind == "bytelevel" else sp_json
    tok, jtok = load_hf_tokenizer(path), jhft.load_hf_tokenizer(path)
    texts = corpus_for_tokenizer() + TEXTS + [render_prompt("go back", {"last_query": "q"})]
    for text in texts:
        for bos, eos in ((False, False), (True, True)):
            assert tok.encode(text, bos=bos, eos=eos) == jtok.encode(text, bos=bos, eos=eos)
        ids = tok.encode(text)
        assert tok.decode(ids) == jtok.decode(ids)
    assert tok.byte_pieces() == jtok.byte_pieces()
    assert (tok.vocab_size, tok.bos_id, tok.eos_id, tok.pad_id, tok.special_ids) == (
        jtok.vocab_size, jtok.bos_id, jtok.eos_id, jtok.pad_id, jtok.special_ids)


def test_the_in_tree_shim_forwards(sp_json):
    tok = Tokenizer.from_hf_tokenizer_json(sp_json)
    assert isinstance(tok, HFTokenizer) and tok.kind == "sentencepiece"


def test_an_unsupported_model_type_is_refused(tmp_path):
    (tmp_path / "tokenizer.json").write_text(json.dumps({"model": {"type": "Unigram"}}))
    with pytest.raises(ValueError, match="unsupported tokenizer model type 'Unigram'"):
        load_hf_tokenizer(tmp_path)


# ---------------------------------------------------------------- the FSM


@pytest.mark.parametrize("kind,pad", [("bytelevel", 0), ("sp", 0), ("bytelevel", 64)])
def test_fsm_tables_equal_jax(bytelevel_json, sp_json, kind, pad):
    """``TokenFSM.table`` and ``col_id`` over a checkpoint tokenizer (padded
    to a wider model vocab or not) equal JAX's exactly."""
    path = bytelevel_json if kind == "bytelevel" else sp_json
    tok, jtok = load_hf_tokenizer(path), jhft.load_hf_tokenizer(path)
    V = tok.vocab_size + pad
    fsm, jfsm = build_fsm_for(tok, vocab_size=V), j_build_fsm_for(jtok, vocab_size=V)
    assert np.array_equal(fsm.table, jfsm.table)
    assert np.array_equal(fsm.col_id, jfsm.col_id)
    assert (fsm.vocab_size, fsm.num_classes, fsm.start) == (V, jfsm.num_classes, jfsm.start)
    ff, jff = fsm.forced_tables(8), jfsm.forced_tables(8)
    assert np.array_equal(ff[0], jff[0]) and np.array_equal(ff[1], jff[1])


@pytest.mark.parametrize("kind", ["bytelevel", "sp"])
def test_fsm_walks_the_grammar_and_pads_are_dead(bytelevel_json, sp_json, kind):
    tok = load_hf_tokenizer(bytelevel_json if kind == "bytelevel" else sp_json)
    fsm = build_fsm_for(tok, vocab_size=tok.vocab_size + 64)
    assert build_fsm_for(tok, vocab_size=tok.vocab_size + 64) is fsm  # cached by width
    assert build_fsm_for(tok) is not fsm
    # a SentencePiece encode prepends ▁ (a space); a decode emits the JSON
    # from its first byte, so walk its pieces without the prefix
    ids = (tok.encode(INTENT_JSON) if kind == "bytelevel"
           else tok._encode_word(tuple(INTENT_JSON)))
    assert tok.decode(ids) == INTENT_JSON
    state = fsm.walk(ids)
    assert state >= 0 and fsm.accepting[state]
    assert fsm.step(state, tok.eos_id) >= 0 and fsm.step(fsm.start, tok.eos_id) < 0
    assert fsm.vocab_size == tok.vocab_size + 64
    assert not fsm.allowed(fsm.start)[tok.vocab_size:].any()
    assert not fsm.mask[:, tok.vocab_size:].any()  # dead in every state
    tables = fsm.device_tables()
    assert tables.dense_mask is not None and tables.table.shape == fsm.table.shape


def test_memory_at_llama3_scale_is_sane(bytelevel_json):
    """At V = 128,256 the compressed tables stay in the tens of MB, and the
    device tables carry no dense mask (S·V is past the 2^25 limit)."""
    tok = load_hf_tokenizer(bytelevel_json)
    fsm = TokenFSM(intent_dfa(), tok, vocab_size=128_256)
    nbytes = fsm.table.nbytes + fsm.col_id.nbytes
    assert nbytes < 64 * 1024 * 1024, f"{nbytes / 1e6:.0f} MB"
    assert fsm.num_states * fsm.vocab_size > 1 << 25
    assert fsm.device_tables().dense_mask is None


def test_fsm_refuses_a_model_vocab_below_the_tokenizer(bytelevel_json):
    tok = load_hf_tokenizer(bytelevel_json)
    with pytest.raises(ValueError, match="smaller than tokenizer vocab"):
        TokenFSM(intent_dfa(), tok, vocab_size=tok.vocab_size - 1)
