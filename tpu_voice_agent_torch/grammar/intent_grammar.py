"""The intent grammar: ParseResponse schema -> regex -> DFA -> TokenFSM.

The schema is read from the committed ``parse_response.schema.json`` (the
JAX package derives the same dict from its pydantic model). Everything here
is derived and cached at process level.
"""

from __future__ import annotations

from functools import lru_cache

from .. import cache_dir
from ..schemas import INTENT_TYPES, TARGET_STRATEGIES, parse_response_schema
from .fsm import TokenFSM
from .jsonschema import schema_to_regex
from .regexlang import DFA, compile_regex
from .tokenizer import Tokenizer


def schema_literals() -> list[str]:
    """Vocab pieces that make intent JSON decode in few tokens."""
    lits: list[str] = []
    keys = [
        "version",
        "intents",
        "type",
        "target",
        "strategy",
        "value",
        "role",
        "name",
        "args",
        "priority",
        "requires_confirmation",
        "timeout_ms",
        "retries",
        "context_updates",
        "confidence",
        "tts_summary",
        "follow_up_question",
        "text",
        "context",
        "session_id",
        "query",
        "url",
        "field",
        "direction",
        "index",
        "fileRef",
        "format",
        "last_query",
    ]
    for k in keys:
        lits.append(f'"{k}":')
        lits.append(f',"{k}":')
    for t in INTENT_TYPES:
        lits.append(f'"{t}"')
    for s in TARGET_STRATEGIES:
        lits.append(f'"{s}"')
    lits += [
        '{"version":"1.0","intents":[',
        '{"type":',
        'null,',
        "null}",
        "null",
        "true",
        "false",
        "true,",
        "false,",
        '":null',
        "[]",
        "{}",
        "}]",
        "},{",
        '":{"',
        '"},',
        '"}',
        '{"',
        '":"',
        '","',
        "15000",
        "10000",
        "0.9",
        "0.8",
        ":1,",
        ":0,",
        ":0}",
        "<|system|>\n",
        "<|user|>\n",
        "<|assistant|>\n",
    ]
    return lits


def intent_regex() -> str:
    return schema_to_regex(parse_response_schema(), overrides={"version": r'"1\.0"'})


@lru_cache(maxsize=1)
def intent_dfa() -> DFA:
    """Compile (or load) the intent DFA.

    The automaton is ~35k states and seconds of pure-python subset
    construction, so the compiled tables are cached on disk keyed by the
    regex hash. The file name carries ``torch`` so this package and the JAX
    package never race on one npz when they share a cache directory."""
    import hashlib
    import os
    import tempfile

    import numpy as np

    rx = intent_regex()
    key = hashlib.sha256(rx.encode()).hexdigest()[:16]
    cdir = cache_dir()
    path = cdir / f"intent_dfa_torch_{key}.npz"
    if path.exists():
        try:
            z = np.load(path)
            return DFA(z["trans"], z["accepting"], z["class_of"], int(z["start"]))
        except Exception:
            # truncated/corrupt cache: recompile (the cache is best-effort)
            try:
                path.unlink()
            except OSError:
                pass
    dfa = compile_regex(rx)
    try:
        cdir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".npz")
        os.close(fd)
        np.savez_compressed(
            tmp, trans=dfa.trans, accepting=dfa.accepting,
            class_of=dfa.class_of, start=np.int64(dfa.start),
        )
        os.replace(tmp, path)  # atomic: concurrent processes race safely
    except OSError:
        pass
    return dfa


@lru_cache(maxsize=1)
def default_tokenizer() -> Tokenizer:
    from ..services.prompts import corpus_for_tokenizer

    return Tokenizer.build(
        corpus=corpus_for_tokenizer(),
        literals=schema_literals(),
        vocab_size=4096,
    )


@lru_cache(maxsize=1)
def build_intent_fsm() -> tuple[Tokenizer, TokenFSM]:
    tok = default_tokenizer()
    return tok, TokenFSM(intent_dfa(), tok)


def build_fsm_for(tokenizer, vocab_size: int | None = None) -> TokenFSM:
    """The intent-grammar FSM over any tokenizer (an ``HFTokenizer`` for a
    checkpoint). ``vocab_size`` may exceed the tokenizer's, to match a
    checkpoint's padded embedding table: the padded ids are grammar-dead.

    The multi-second build is cached ON the tokenizer object, keyed by the
    vocab width, so the cache lives and dies with the tokenizer (an
    ``id()``-keyed global could alias a recycled address to another
    tokenizer's tables)."""
    cache = tokenizer.__dict__.setdefault("_intent_fsm_cache", {})
    key = int(vocab_size or tokenizer.vocab_size)
    fsm = cache.get(key)
    if fsm is None:
        fsm = TokenFSM(intent_dfa(), tokenizer, vocab_size=vocab_size)
        cache[key] = fsm
    return fsm
