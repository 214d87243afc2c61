"""Real-checkpoint tokenizers from HF ``tokenizer.json`` — true BPE merges.

A copy of the JAX package's ``grammar/hf_tokenizer.py`` (plain Python and
the stdlib ``re``: no ``tokenizers`` package), so both packages segment a
prompt into the same ids. It implements the BPE merge procedure for the two
families every target checkpoint uses, over the checkpoint's own
tokenizer.json:

- **byte-level BPE** (GPT-2 lineage: Whisper, Qwen2, Llama-3): vocab keys
  are byte-to-unicode remapped strings (Ġ = space); encoding pretokenizes
  with a GPT-2-style regex, remaps bytes, then merges lowest-rank pairs.
  The pretokenization regex is an ASCII-faithful approximation of the
  published \\p{L}-class patterns (python ``re`` has no unicode property
  classes); byte content per token — what grammar-constrained decoding
  actually depends on — is exact for every token.
- **sentencepiece-style BPE** (Llama-2 lineage: TinyLlama): pieces use ▁
  for space plus ``<0xNN>`` byte-fallback; the normalizer prepends ▁ and
  replaces spaces, then the same rank-merge loop runs over characters.

Special ids (bos/eos/pad) come from the checkpoint's added_tokens, not from
module constants — the engine reads ``tok.bos_id``/``tok.eos_id``.

Interface matches grammar.tokenizer.Tokenizer: encode/decode/token_bytes/
byte_pieces/vocab_size/pad_id/bos_id/eos_id, so TokenFSM and the engines are
tokenizer-agnostic.
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path

_INF = 1 << 30

# GPT-2-style pretokenizer, ASCII approximation of the \p{L}/\p{N} classes.
_PRETOK = re.compile(
    r"'(?:[sdmt]|ll|ve|re)"
    r"| ?[^\W\d_]+"
    r"| ?\d+"
    r"| ?(?:[^\w\s]|_)+"
    r"|\s+(?!\S)"
    r"|\s+",
    re.UNICODE,
)

_BYTE_RE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2's invertible byte -> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def _unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in _byte_to_unicode().items()}


def _apply_merges(word: tuple[str, ...], ranks: dict[tuple[str, str], int]) -> tuple[str, ...]:
    """Classic BPE: repeatedly merge the lowest-rank adjacent pair."""
    while len(word) > 1:
        best_rank = _INF
        for pair in zip(word, word[1:]):
            r = ranks.get(pair, _INF)
            if r < best_rank:
                best_rank = r
                best = pair
        if best_rank == _INF:
            break
        a, b = best
        out: list[str] = []
        j = 0
        n = len(word)
        while j < n:
            if j < n - 1 and word[j] == a and word[j + 1] == b:
                out.append(a + b)
                j += 2
            else:
                out.append(word[j])
                j += 1
        word = tuple(out)
    return word


_BOS_NAMES = ("<s>", "<|begin_of_text|>", "<|startoftext|>")
_EOS_NAMES = ("</s>", "<|end_of_text|>", "<|eot_id|>", "<|endoftext|>", "<|im_end|>")
_PAD_NAMES = ("<pad>", "<|pad|>", "<unk>")


class HFTokenizer:
    """BPE tokenizer reconstructed from an HF tokenizer.json."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        kind: str,  # "byte_level" | "sentencepiece"
        added: dict[str, int] | None = None,
        bos: str | None = None,
        eos: str | None = None,
        prepend: str | None = None,  # sentencepiece Prepend normalizer content
    ):
        if kind not in ("byte_level", "sentencepiece"):
            raise ValueError(f"unknown tokenizer kind {kind!r}")
        self.kind = kind
        self.vocab = dict(vocab)
        self.added = dict(added or {})
        for tok, tid in self.added.items():
            self.vocab.setdefault(tok, tid)
        self.vocab_size = max(self.vocab.values()) + 1
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.id_to_tok: dict[int, str] = {}
        for tok, tid in self.vocab.items():
            self.id_to_tok.setdefault(tid, tok)
        self.special_ids = set(self.added.values())
        self.prepend = prepend

        def find(names: tuple[str, ...], override: str | None) -> int | None:
            if override is not None:
                if override not in self.vocab:
                    raise ValueError(f"special token {override!r} not in vocab")
                return self.vocab[override]
            for nm in names:
                if nm in self.vocab:
                    return self.vocab[nm]
            return None

        self.bos_id = find(_BOS_NAMES, bos)
        self.eos_id = find(_EOS_NAMES, eos)
        if self.eos_id is None:
            raise ValueError("tokenizer.json has no recognizable EOS token")
        if self.bos_id is None:
            self.bos_id = self.eos_id
        pad = find(_PAD_NAMES, None)
        self.pad_id = pad if pad is not None else 0
        self.special_ids |= {self.bos_id, self.eos_id}

        # byte content per id (None = non-emitting special)
        self._pieces: list = [None] * self.vocab_size
        u2b = _unicode_to_byte()
        for tok, tid in self.vocab.items():
            if tid in self.special_ids:
                continue
            if self.kind == "byte_level":
                try:
                    self._pieces[tid] = bytes(u2b[c] for c in tok)
                except KeyError:
                    self._pieces[tid] = None  # added non-special marker token
            else:
                m = _BYTE_RE.match(tok)
                if m:
                    self._pieces[tid] = bytes([int(m.group(1), 16)])
                else:
                    self._pieces[tid] = tok.replace("▁", " ").encode()

        # regex that splits input on added-token strings (longest first)
        specials = sorted(self.added, key=len, reverse=True)
        self._special_split = (
            re.compile("(" + "|".join(re.escape(s) for s in specials) + ")")
            if specials
            else None
        )
        self._b2u = _byte_to_unicode()

    # ------------------------------------------------------------ encode

    def _encode_word(self, word: tuple[str, ...]) -> list[int]:
        ids: list[int] = []
        for sym in _apply_merges(word, self.ranks):
            tid = self.vocab.get(sym)
            if tid is not None:
                ids.append(tid)
                continue
            # byte fallback (sentencepiece <0xNN> pieces)
            for b in sym.encode():
                bt = self.vocab.get(f"<0x{b:02X}>")
                if bt is not None:
                    ids.append(bt)
        return ids

    def _encode_segment(self, text: str) -> list[int]:
        if not text:
            return []
        if self.kind == "byte_level":
            ids: list[int] = []
            for m in _PRETOK.finditer(text):
                mapped = "".join(self._b2u[b] for b in m.group(0).encode())
                ids.extend(self._encode_word(tuple(mapped)))
            return ids
        # sentencepiece: the Prepend normalizer applies to EVERY non-special
        # segment (HF runs normalization per split piece, so text following
        # a special token still gets its ▁ prefix), then space -> ▁
        norm = text.replace(" ", "▁")
        if self.prepend:
            norm = self.prepend + norm
        return self._encode_word(tuple(norm))

    def encode(self, text: str, bos: bool = False, eos: bool = False) -> list[int]:
        ids: list[int] = [self.bos_id] if bos else []
        if self._special_split is not None:
            for part in self._special_split.split(text):
                if part in self.added:
                    ids.append(self.added[part])
                else:
                    ids.extend(self._encode_segment(part))
        else:
            ids.extend(self._encode_segment(text))
        if eos:
            ids.append(self.eos_id)
        return ids

    # ------------------------------------------------------------ decode

    def token_bytes(self, token_id: int) -> bytes:
        p = self._pieces[token_id] if 0 <= token_id < self.vocab_size else None
        return p if p is not None else b""

    def byte_pieces(self) -> list:
        return self._pieces

    def decode(self, ids: list[int]) -> str:
        out = b"".join(self.token_bytes(i) for i in ids)
        text = out.decode(errors="replace")
        # sentencepiece decoders strip the prepended space
        if self.kind == "sentencepiece" and self.prepend and text.startswith(" "):
            text = text[1:]
        return text

    def id_of(self, content: str) -> int | None:
        return self.vocab.get(content)


def load_hf_tokenizer(
    path: str | Path,
    bos: str | None = None,
    eos: str | None = None,
) -> HFTokenizer:
    """Build an HFTokenizer from a tokenizer.json file (or its directory)."""
    p = Path(path)
    if p.is_dir():
        p = p / "tokenizer.json"
    obj = json.loads(p.read_text())
    model = obj.get("model", {})
    if model.get("type") not in (None, "BPE"):
        raise ValueError(f"unsupported tokenizer model type {model.get('type')!r}")
    vocab: dict[str, int] = model.get("vocab", {})
    merges_raw = model.get("merges", [])
    merges: list[tuple[str, str]] = []
    for m in merges_raw:
        if isinstance(m, str):
            a, _, b = m.partition(" ")
            merges.append((a, b))
        else:
            merges.append((m[0], m[1]))

    added = {
        t["content"]: t["id"]
        for t in obj.get("added_tokens", [])
        if t.get("special", True) or t["content"] not in vocab
    }

    # family detection: byte-level vocabs contain the Ġ space marker or a
    # ByteLevel pre_tokenizer; sentencepiece vocabs carry ▁ pieces or <0xNN>
    def has_bytelevel(component) -> bool:
        if not isinstance(component, dict):
            return False
        if component.get("type") == "ByteLevel":
            return True
        subs = component.get("pretokenizers") or component.get("normalizers") or []
        return any(has_bytelevel(s) for s in subs)

    if has_bytelevel(obj.get("pre_tokenizer")) or any(
        "Ġ" in t for t in list(vocab)[:2000]
    ):
        kind = "byte_level"
        prepend = None
    else:
        kind = "sentencepiece"
        prepend = "▁"
        norm = obj.get("normalizer") or {}
        subs = norm.get("normalizers", [norm]) if norm else []
        for s in subs:
            if isinstance(s, dict) and s.get("type") == "Prepend":
                prepend = s.get("prepend", "▁")
    return HFTokenizer(
        vocab=vocab, merges=merges, kind=kind, added=added, bos=bos, eos=eos,
        prepend=prepend,
    )
