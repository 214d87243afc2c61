"""Byte-level regex -> NFA -> DFA compiler.

This is the foundation of grammar-constrained decoding: the intent JSON schema
compiles to a regex (jsonschema.py), which compiles here to a dense DFA over
byte-equivalence classes, which fsm.py lifts to a token-level transition table
used as a per-step logit mask on TPU. The reference repo has nothing like
this — it validates *after* sampling and re-asks the LLM on failure
(apps/brain/src/server.ts:110-121); we make invalid JSON unrepresentable.

Supported syntax: literals, escapes (\\d \\w \\s \\n \\t \\r and escaped
metachars), character classes ``[a-z0-9_]`` / ``[^...]``, grouping ``()``,
alternation ``|``, quantifiers ``* + ? {m} {m,} {m,n}``, and ``.`` (printable
ASCII incl. space). Patterns are ASCII; the DFA alphabet is bytes 0..255.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DEAD = -1

_PRINTABLE = frozenset(range(0x20, 0x7F))
_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B)) + list(range(0x61, 0x7B)) + [0x5F]
)
_SPACE = frozenset({0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C})
_ALL = frozenset(range(256))


# ---------------------------------------------------------------- AST


@dataclass
class Node:
    pass


@dataclass
class Lit(Node):
    chars: frozenset  # set of byte values


@dataclass
class Seq(Node):
    parts: list


@dataclass
class Alt(Node):
    options: list


@dataclass
class Rep(Node):
    child: Node
    lo: int
    hi: int | None  # None = unbounded


# ---------------------------------------------------------------- parser


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> Node:
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i} in regex")
        return node

    def _alt(self) -> Node:
        options = [self._seq()]
        while self.peek() == "|":
            self.next()
            options.append(self._seq())
        return options[0] if len(options) == 1 else Alt(options)

    def _seq(self) -> Node:
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self._repeat())
        if len(parts) == 1:
            return parts[0]
        return Seq(parts)

    def _repeat(self) -> Node:
        atom = self._atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.next()
                atom = Rep(atom, 0, None)
            elif ch == "+":
                self.next()
                atom = Rep(atom, 1, None)
            elif ch == "?":
                self.next()
                atom = Rep(atom, 0, 1)
            elif ch == "{":
                self.next()
                lo = self._int()
                hi: int | None = lo
                if self.peek() == ",":
                    self.next()
                    hi = None if self.peek() == "}" else self._int()
                if self.next() != "}":
                    raise ValueError("unterminated {m,n}")
                if hi is not None and hi < lo:
                    raise ValueError(f"inverted quantifier {{{lo},{hi}}}")
                atom = Rep(atom, lo, hi)
            else:
                return atom

    def _int(self) -> int:
        s = ""
        while self.peek() is not None and self.peek().isdigit():
            s += self.next()
        if not s:
            raise ValueError("expected integer in quantifier")
        return int(s)

    def _atom(self) -> Node:
        ch = self.next()
        if ch == "(":
            node = self._alt()
            if self.peek() != ")":
                raise ValueError("unbalanced (")
            self.next()
            return node
        if ch == "[":
            return self._cls()
        if ch == ".":
            return Lit(_PRINTABLE)
        if ch == "\\":
            return Lit(self._escape(self.next()))
        if ch in "*+?{}|)":
            raise ValueError(f"unexpected metachar {ch!r}")
        return Lit(frozenset({ord(ch)}))

    def _escape(self, ch: str) -> frozenset:
        if ch == "d":
            return _DIGITS
        if ch == "w":
            return _WORD
        if ch == "s":
            return _SPACE
        if ch == "n":
            return frozenset({0x0A})
        if ch == "t":
            return frozenset({0x09})
        if ch == "r":
            return frozenset({0x0D})
        return frozenset({ord(ch)})

    def _cls(self) -> Node:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        chars: set[int] = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise ValueError("unterminated [")
            if ch == "]" and not first:
                self.next()
                break
            first = False
            self.next()
            if ch == "\\":
                esc = self.next()
                sub = self._escape(esc)
                if len(sub) != 1:
                    # multi-char class (\d, \w, \s) cannot anchor a range
                    chars |= sub
                    continue
                lo = next(iter(sub))
            else:
                lo = ord(ch)
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.next()
                hi_ch = self.next()
                if hi_ch == "\\":
                    hi_set = self._escape(self.next())
                    if len(hi_set) != 1:
                        raise ValueError("class range endpoint cannot be \\d/\\w/\\s")
                    hi = next(iter(hi_set))
                else:
                    hi = ord(hi_ch)
                if hi < lo:
                    raise ValueError(f"inverted class range {chr(lo)}-{chr(hi)}")
                chars.update(range(lo, hi + 1))
            else:
                chars.add(lo)
        return Lit(frozenset(_ALL - chars) if negate else frozenset(chars))


# ---------------------------------------------------------------- NFA


@dataclass
class _NFAState:
    eps: list = field(default_factory=list)
    edges: list = field(default_factory=list)  # (class_id placeholder charset, dst)


class _NFA:
    def __init__(self) -> None:
        self.states: list[_NFAState] = []

    def new(self) -> int:
        self.states.append(_NFAState())
        return len(self.states) - 1

    def compile(self, node: Node) -> tuple[int, int]:
        """Thompson construction: returns (start, accept)."""
        if isinstance(node, Lit):
            s, e = self.new(), self.new()
            self.states[s].edges.append((node.chars, e))
            return s, e
        if isinstance(node, Seq):
            if not node.parts:
                s = self.new()
                return s, s
            s, e = self.compile(node.parts[0])
            for part in node.parts[1:]:
                s2, e2 = self.compile(part)
                self.states[e].eps.append(s2)
                e = e2
            return s, e
        if isinstance(node, Alt):
            s, e = self.new(), self.new()
            for opt in node.options:
                os, oe = self.compile(opt)
                self.states[s].eps.append(os)
                self.states[oe].eps.append(e)
            return s, e
        if isinstance(node, Rep):
            lo, hi = node.lo, node.hi
            if hi is None:
                # child{lo,} = child^lo followed by child*
                s = e = self.new()
                for _ in range(lo):
                    cs, ce = self.compile(node.child)
                    self.states[e].eps.append(cs)
                    e = ce
                ks, ke = self.compile(node.child)
                loop_in = self.new()
                self.states[e].eps.append(loop_in)
                self.states[loop_in].eps.append(ks)
                self.states[ke].eps.append(loop_in)
                return s, loop_in
            # bounded: child^lo then up to (hi-lo) optional copies. Each
            # optional copy eps-exits DIRECTLY to one shared exit state —
            # a skip-CHAIN here makes every epsilon closure drag in all
            # downstream skips, turning subset construction quadratic in
            # the repetition count (fatal for {0,160} string bounds).
            s = e = self.new()
            for _ in range(lo):
                cs, ce = self.compile(node.child)
                self.states[e].eps.append(cs)
                e = ce
            exit_ = self.new()
            self.states[e].eps.append(exit_)
            cur = e
            for _ in range(hi - lo):
                cs, ce = self.compile(node.child)
                self.states[cur].eps.append(cs)
                self.states[ce].eps.append(exit_)
                cur = ce
            return s, exit_
        raise TypeError(node)


# ---------------------------------------------------------------- DFA


class DFA:
    """Dense DFA over byte-equivalence classes.

    Attributes:
      trans:      (num_states, num_classes) int32, DEAD=-1
      accepting:  (num_states,) bool
      class_of:   (256,) int32 byte -> class id
      start:      int
    """

    def __init__(self, trans: np.ndarray, accepting: np.ndarray, class_of: np.ndarray, start: int):
        self.trans = trans
        self.accepting = accepting
        self.class_of = class_of
        self.start = start

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    def step_byte(self, state: int, byte: int) -> int:
        if state == DEAD:
            return DEAD
        return int(self.trans[state, self.class_of[byte]])

    def matches(self, data: bytes) -> bool:
        s = self.start
        for b in data:
            s = self.step_byte(s, b)
            if s == DEAD:
                return False
        return bool(self.accepting[s])

    def accepts_prefix(self, data: bytes) -> bool:
        """True if data is a viable prefix of some accepted string."""
        s = self.start
        for b in data:
            s = self.step_byte(s, b)
            if s == DEAD:
                return False
        return True


def _byte_classes(node: Node) -> np.ndarray:
    """Partition 0..255 into equivalence classes over all charsets in the AST."""
    sets: list[frozenset] = []

    def walk(n: Node) -> None:
        if isinstance(n, Lit):
            sets.append(n.chars)
        elif isinstance(n, Seq):
            for p in n.parts:
                walk(p)
        elif isinstance(n, Alt):
            for p in n.options:
                walk(p)
        elif isinstance(n, Rep):
            walk(n.child)

    walk(node)
    # signature of each byte = which charsets contain it
    masks = []
    for s in sets:
        arr = np.zeros(256, dtype=bool)
        arr[list(s)] = True
        masks.append(arr)
    if masks:
        mat = np.stack(masks, axis=1)  # (256, n_sets)
    else:
        mat = np.zeros((256, 0), dtype=bool)
    class_of = np.zeros(256, dtype=np.int32)
    seen: dict[bytes, int] = {}
    for b in range(256):
        key = mat[b].tobytes()
        if key not in seen:
            seen[key] = len(seen)
        class_of[b] = seen[key]
    return class_of


def compile_regex(pattern: str) -> DFA:
    ast = _Parser(pattern).parse()
    class_of = _byte_classes(ast)
    num_classes = int(class_of.max()) + 1
    # representative byte per class
    rep: list[int] = [0] * num_classes
    for b in range(255, -1, -1):
        rep[class_of[b]] = b

    nfa = _NFA()
    start, accept = nfa.compile(ast)

    # epsilon-closure per NFA state (cached, iterative DFS)
    n = len(nfa.states)
    closure_cache: dict[int, frozenset] = {}

    def closure(of: frozenset) -> frozenset:
        out: set[int] = set()
        stack = list(of)
        while stack:
            s = stack.pop()
            if s in out:
                continue
            out.add(s)
            cached = closure_cache.get(s)
            if cached is not None:
                out |= cached
                continue
            stack.extend(nfa.states[s].eps)
        return frozenset(out)

    for s in range(n):
        closure_cache[s] = closure(frozenset({s})) - {s}

    # precompute per-NFA-state: class_id -> set of dsts
    per_state_moves: list[dict[int, list[int]]] = []
    for st in nfa.states:
        moves: dict[int, list[int]] = {}
        for chars, dst in st.edges:
            cls_ids = {int(class_of[b]) for b in chars}
            for c in cls_ids:
                moves.setdefault(c, []).append(dst)
        per_state_moves.append(moves)

    start_set = closure(frozenset({start}))
    dfa_states: dict[frozenset, int] = {start_set: 0}
    worklist = [start_set]
    trans_rows: list[list[int]] = []
    accepting: list[bool] = []

    while worklist:
        cur = worklist.pop()
        idx = dfa_states[cur]
        while len(trans_rows) <= idx:
            trans_rows.append([DEAD] * num_classes)
            accepting.append(False)
        accepting[idx] = accept in cur
        by_class: dict[int, set[int]] = {}
        for s in cur:
            for c, dsts in per_state_moves[s].items():
                by_class.setdefault(c, set()).update(dsts)
        for c, dsts in by_class.items():
            nxt = closure(frozenset(dsts))
            if nxt not in dfa_states:
                dfa_states[nxt] = len(dfa_states)
                worklist.append(nxt)
            trans_rows[idx][c] = dfa_states[nxt]

    # fill rows created after the loop for late-discovered states
    while len(trans_rows) < len(dfa_states):
        trans_rows.append([DEAD] * num_classes)
        accepting.append(False)
    for sset, idx in dfa_states.items():
        accepting[idx] = accept in sset

    trans = np.asarray(trans_rows, dtype=np.int32)
    return DFA(trans, np.asarray(accepting, dtype=bool), class_of, 0)
