"""In-tree byte-fallback tokenizer with a trainable BPE vocab.

No network egress is assumed anywhere in this framework, so instead of
downloading an HF tokenizer we build one: 256 byte pieces guarantee coverage,
a BPE pass over an in-repo corpus (system prompt + few-shots + sample
utterances) adds common English/JSON merges, and schema literals (quoted keys,
intent type names, punctuation runs) are injected verbatim so an entire intent
JSON decodes in tens of steps rather than hundreds of byte steps. Encoding is
greedy longest-match (trie) — any token sequence's bytes walk the grammar DFA
identically regardless of segmentation, which is what constrained decoding
needs.

A copy of the JAX package's ``grammar/tokenizer.py`` (plain Python, so the
port builds byte-identical vocabularies). Checkpoint tokenizers (HF
``tokenizer.json``) are ``grammar.hf_tokenizer``'s.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SPECIALS = ("<pad>", "<bos>", "<eos>")


def train_bpe(corpus: list[str], num_merges: int) -> list[bytes]:
    """Classic BPE merge learning over pre-tokenized words.

    Pre-tokenization splits at every non-alphanumeric character (each such
    character becomes its own one-byte word), so merges never span a word or
    punctuation boundary; multi-char JSON glue is supplied as injected
    literals instead (intent_grammar.schema_literals). Returns learned merge
    pieces (byte strings), most frequent first.
    """
    words: Counter[tuple[bytes, ...]] = Counter()
    for text in corpus:
        buf = ""
        for ch in text:
            if ch.isalnum():
                buf += ch
            else:
                if buf:
                    words[tuple(bytes([b]) for b in buf.encode())] += 1
                    buf = ""
                words[tuple(bytes([b]) for b in ch.encode())] += 1
        if buf:
            words[tuple(bytes([b]) for b in buf.encode())] += 1

    merges: list[bytes] = []
    work = dict(words)
    for _ in range(num_merges):
        pairs: Counter[tuple[bytes, bytes]] = Counter()
        for word, cnt in work.items():
            for a, b in zip(word, word[1:]):
                pairs[(a, b)] += cnt
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merged = a + b
        merges.append(merged)
        new_work: dict[tuple[bytes, ...], int] = {}
        for word, wcnt in work.items():
            out: list[bytes] = []
            i = 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            key = tuple(out)
            new_work[key] = new_work.get(key, 0) + wcnt
        work = new_work
    return merges


class Tokenizer:
    """Greedy longest-match tokenizer over a byte-complete vocab.

    Exposes the interface every tokenizer in the framework satisfies
    (grammar.hf_tokenizer.HFTokenizer is the real-checkpoint twin):
    ``encode/decode/token_bytes/byte_pieces``, ``vocab_size`` and the
    instance special ids ``pad_id/bos_id/eos_id`` (engines must use these,
    never the module constants — real checkpoints place them elsewhere).
    """

    def __init__(self, pieces: list[bytes]):
        # pieces[i] is the byte string for id i + len(SPECIALS)
        self.pieces = pieces
        self.vocab_size = len(SPECIALS) + len(pieces)
        self.pad_id = PAD_ID
        self.bos_id = BOS_ID
        self.eos_id = EOS_ID
        self.piece_bytes: list[bytes] = [s.encode() for s in SPECIALS] + pieces
        self._trie: dict = {}
        for idx, piece in enumerate(pieces):
            node = self._trie
            for b in piece:
                node = node.setdefault(b, {})
            node[-1] = idx + len(SPECIALS)

    @classmethod
    def build(
        cls,
        corpus: list[str] | None = None,
        literals: list[str] | None = None,
        vocab_size: int = 4096,
    ) -> "Tokenizer":
        pieces: list[bytes] = [bytes([b]) for b in range(256)]
        seen = set(pieces)

        def add(p: bytes) -> None:
            if p and p not in seen and len(pieces) + len(SPECIALS) < vocab_size:
                pieces.append(p)
                seen.add(p)

        for lit in literals or []:
            add(lit.encode())
        budget = vocab_size - len(SPECIALS) - len(pieces)
        if corpus and budget > 0:
            for piece in train_bpe(corpus, num_merges=budget * 2):
                add(piece)
        return cls(pieces)

    def encode(self, text: str, bos: bool = False, eos: bool = False) -> list[int]:
        data = text.encode()
        ids: list[int] = [BOS_ID] if bos else []
        i = 0
        n = len(data)
        while i < n:
            node = self._trie
            best_id = None
            best_len = 0
            j = i
            while j < n and data[j] in node:
                node = node[data[j]]
                j += 1
                if -1 in node:
                    best_id = node[-1]
                    best_len = j - i
            if best_id is None:
                # byte fallback always exists
                best_id = data[i] + len(SPECIALS)
                best_len = 1
            ids.append(best_id)
            i += best_len
        if eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: list[int]) -> str:
        out = b"".join(self.token_bytes(i) for i in ids)
        return out.decode(errors="replace")

    def token_bytes(self, token_id: int) -> bytes:
        """Bytes a token contributes to the stream ('' for specials or
        padded-vocab ids past the table — mesh engines pad the model vocab
        to a tp multiple)."""
        if token_id < len(SPECIALS) or token_id >= len(self.piece_bytes):
            return b""
        return self.piece_bytes[token_id]

    def byte_pieces(self) -> list:
        """Per-id byte content; None/b'' for non-emitting specials (the
        TokenFSM builds its vocab trie from this)."""
        return [None] * len(SPECIALS) + self.pieces

    # -------------------------------------------------- persistence

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps({"pieces": [p.hex() for p in self.pieces]})
        )

    @classmethod
    def load(cls, path: str | Path) -> "Tokenizer":
        obj = json.loads(Path(path).read_text())
        return cls([bytes.fromhex(h) for h in obj["pieces"]])

    @classmethod
    def from_hf_tokenizer_json(cls, path: str | Path):
        """Checkpoint tokenizers live in grammar.hf_tokenizer (true BPE
        merges, byte-level and sentencepiece families, the checkpoint's own
        special ids); kept as a forwarding shim, as in the JAX package."""
        from .hf_tokenizer import load_hf_tokenizer

        return load_hf_tokenizer(path)
