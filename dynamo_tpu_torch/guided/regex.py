"""Byte-level regex -> DFA compiler for guided decoding.

The reference forwards guided_json/guided_regex/guided_choice to engines
that constrain sampling with a compiled grammar (nvext fields,
lib/llm/src/protocols/openai/common_ext.rs:175-219; GuidedDecodingOptions,
lib/llm/src/protocols/common.rs:336). This framework owns its engine, so
the compiler lives here: a regex subset is parsed to an NFA (Thompson
construction) and determinized (subset construction) over a byte alphabet
partitioned into equivalence classes, producing a dense DFA transition
table the token layer (guided/tokens.py) products against the tokenizer
vocabulary.

Byte-level semantics: patterns match UTF-8 BYTES. ASCII classes work as
expected; `.` additionally admits non-ASCII continuation bytes so UTF-8
text flows through. This is the outlines/xgrammar-style approximation —
sound for constraining structure (JSON syntax, enums, numbers), which is
what guided decoding is for.

Supported syntax: literals, escapes (\\n \\t \\r \\\\ \\. etc), classes
[abc] [a-z0-9] [^...], ., \\d \\w \\s and negations, quantifiers * + ?
{m} {m,} {m,n}, alternation |, groups (). Anchored fullmatch semantics
(like re.fullmatch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np


class RegexError(ValueError):
    pass


# ----------------------------------------------------------------- parsing
# AST: ("lit", frozenset[int]) | ("cat", [..]) | ("alt", [..])
#      | ("star", node) | ("plus", node) | ("opt", node) | ("eps",)

_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F]
)
_SPACE = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C])
_ALL = frozenset(range(256))
# `.`: any byte except newline; includes 0x80-0xFF so UTF-8 payload bytes
# inside strings are representable
_DOT = _ALL - frozenset([0x0A])

_ESCAPES = {
    "n": frozenset([0x0A]), "t": frozenset([0x09]), "r": frozenset([0x0D]),
    "f": frozenset([0x0C]), "v": frozenset([0x0B]), "0": frozenset([0x00]),
    "d": _DIGITS, "D": _ALL - _DIGITS,
    "w": _WORD, "W": _ALL - _WORD,
    "s": _SPACE, "S": _ALL - _SPACE,
}


class _Parser:
    def __init__(self, pattern: str):
        self.b = pattern.encode("utf-8")
        self.i = 0

    def peek(self) -> Optional[int]:
        return self.b[self.i] if self.i < len(self.b) else None

    def next(self) -> int:
        if self.i >= len(self.b):
            raise RegexError("unexpected end of pattern")
        c = self.b[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self.alt()
        if self.i != len(self.b):
            raise RegexError(f"unbalanced pattern at byte {self.i}")
        return node

    def alt(self):
        branches = [self.cat()]
        while self.peek() == 0x7C:  # |
            self.next()
            branches.append(self.cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def cat(self):
        parts = []
        while True:
            c = self.peek()
            if c is None or c in (0x7C, 0x29):  # | )
                break
            parts.append(self.repeat())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def repeat(self):
        node = self.atom()
        while True:
            c = self.peek()
            if c == 0x2A:    # *
                self.next(); node = ("star", node)
            elif c == 0x2B:  # +
                self.next(); node = ("plus", node)
            elif c == 0x3F:  # ?
                self.next(); node = ("opt", node)
            elif c == 0x7B:  # {m,n}
                node = self.bounded(node)
            else:
                return node

    def bounded(self, node):
        self.next()  # {
        lo = self._int()
        hi = lo
        if self.peek() == 0x2C:  # ,
            self.next()
            hi = self._int() if self.peek() != 0x7D else None
        if self.next() != 0x7D:
            raise RegexError("expected }")
        if hi is not None and hi < lo:
            raise RegexError("bad {m,n} bounds")
        parts = [node] * lo
        if hi is None:
            parts.append(("star", node))
        else:
            parts.extend([("opt", node)] * (hi - lo))
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    # {m,n} expansion materializes m+n AST copies and as many NFA states, so
    # an uncapped user-supplied count is an allocation bomb at PARSE time
    # (validate_pattern runs on the frontend event loop)
    MAX_REPEAT = 4096

    def _int(self) -> int:
        ds = []
        while self.peek() is not None and 0x30 <= self.peek() <= 0x39:
            ds.append(self.next() - 0x30)
        if not ds:
            raise RegexError("expected integer in {}")
        v = 0
        for d in ds:
            v = v * 10 + d
            if v > self.MAX_REPEAT:
                raise RegexError(
                    f"repetition count exceeds {self.MAX_REPEAT}"
                )
        return v

    def atom(self):
        c = self.next()
        if c == 0x28:  # (
            # non-capturing group marker (?: accepted and ignored
            if self.peek() == 0x3F:
                self.next()
                if self.next() != 0x3A:
                    raise RegexError("only (?: groups supported")
            node = self.alt()
            if self.next() != 0x29:
                raise RegexError("expected )")
            return node
        if c == 0x5B:  # [
            return ("lit", self.char_class())
        if c == 0x2E:  # .
            return ("lit", _DOT)
        if c == 0x5C:  # backslash
            return ("lit", self.escape())
        if c in (0x2A, 0x2B, 0x3F, 0x7B, 0x7D, 0x29):
            raise RegexError(f"unexpected {chr(c)!r}")
        return ("lit", frozenset([c]))

    def escape(self) -> FrozenSet[int]:
        c = self.next()
        ch = chr(c)
        if ch in _ESCAPES:
            return _ESCAPES[ch]
        if ch == "x":
            h = chr(self.next()) + chr(self.next())
            return frozenset([int(h, 16)])
        return frozenset([c])  # escaped literal (\. \[ \\ ...)

    def char_class(self) -> FrozenSet[int]:
        negate = False
        if self.peek() == 0x5E:  # ^
            self.next()
            negate = True
        members: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexError("unterminated [...]")
            if c == 0x5D and not first:  # ]
                self.next()
                break
            first = False
            c = self.next()
            if c == 0x5C:
                s = self.escape()
                if len(s) > 1:  # \d etc inside class
                    members |= s
                    continue
                c = next(iter(s))
            # range a-b (a lone trailing - is a literal)
            if self.peek() == 0x2D and self.i + 1 < len(self.b) and self.b[self.i + 1] != 0x5D:
                self.next()
                hi = self.next()
                if hi == 0x5C:
                    s = self.escape()
                    if len(s) != 1:
                        raise RegexError("class range to multi-byte escape")
                    hi = next(iter(s))
                if hi < c:
                    raise RegexError("reversed class range")
                members |= set(range(c, hi + 1))
            else:
                members.add(c)
        return frozenset(_ALL - members) if negate else frozenset(members)


# ----------------------------------------------------- NFA (Thompson) -> DFA


class _Nfa:
    """States are ints; transitions state -> [(byteset, state)]; eps edges
    separate. One start, one accept (Thompson invariant).

    ``max_states`` caps the BUILD, not just the later subset construction:
    nested bounded repeats multiply through shared AST nodes (parsing
    "((a{k}){k}){k}" is cheap, building its NFA is k^3), so an uncapped
    build is an allocation bomb that parse-time validation cannot see."""

    def __init__(self, max_states: int = 1 << 20):
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []
        self.eps: List[List[int]] = []
        self.max_states = max_states

    def new_state(self) -> int:
        if len(self.edges) >= self.max_states:
            raise RegexError(
                f"pattern expands past {self.max_states} NFA states; "
                "simplify nested repetitions"
            )
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1

    def build(self, node) -> Tuple[int, int]:
        kind = node[0]
        if kind == "eps":
            s = self.new_state(); a = self.new_state()
            self.eps[s].append(a)
            return s, a
        if kind == "lit":
            s = self.new_state(); a = self.new_state()
            self.edges[s].append((node[1], a))
            return s, a
        if kind == "cat":
            first_s, prev_a = self.build(node[1][0])
            for child in node[1][1:]:
                cs, ca = self.build(child)
                self.eps[prev_a].append(cs)
                prev_a = ca
            return first_s, prev_a
        if kind == "alt":
            s = self.new_state(); a = self.new_state()
            for child in node[1]:
                cs, ca = self.build(child)
                self.eps[s].append(cs)
                self.eps[ca].append(a)
            return s, a
        if kind == "star":
            cs, ca = self.build(node[1])
            s = self.new_state(); a = self.new_state()
            self.eps[s] += [cs, a]
            self.eps[ca] += [cs, a]
            return s, a
        if kind == "plus":
            cs, ca = self.build(node[1])
            s = self.new_state(); a = self.new_state()
            self.eps[s].append(cs)
            self.eps[ca] += [cs, a]
            return s, a
        if kind == "opt":
            cs, ca = self.build(node[1])
            s = self.new_state(); a = self.new_state()
            self.eps[s] += [cs, a]
            self.eps[ca].append(a)
            return s, a
        raise RegexError(f"unknown node {kind}")


@dataclasses.dataclass
class Dfa:
    """Dense byte-level DFA. trans[s, b] = next state or -1 (reject);
    accept[s] = True for match states. State 0 is the start."""

    trans: np.ndarray          # [S, 256] int32
    accept: np.ndarray         # [S] bool

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    def matches(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = int(self.trans[s, b])
            if s < 0:
                return False
        return bool(self.accept[s])

    def live(self, s: int) -> bool:
        """Any outgoing transition? False at dead-end accept states (match
        is complete — only EOS can follow)."""
        return bool((self.trans[s] >= 0).any())


def compile_regex(pattern: str, max_states: int = 32768) -> Dfa:
    """Parse + Thompson NFA + subset construction (over the partition of
    the byte alphabet induced by the NFA's edge sets, so determinization
    cost scales with distinct byte-classes, not 256)."""
    ast = _Parser(pattern).parse()
    nfa = _Nfa(max_states=max(1 << 16, 8 * max_states))
    start, accept = nfa.build(ast)

    # alphabet partition: bytes with identical edge membership everywhere
    sig = np.zeros(256, np.int64)
    seen: Dict[FrozenSet[int], int] = {}
    for es in nfa.edges:
        for byteset, _dst in es:
            if byteset not in seen:
                seen[byteset] = len(seen)
                arr = np.zeros(256, bool)
                arr[list(byteset)] = True
                # fold this set's membership into the per-byte signature
                sig = sig * 2 + arr.astype(np.int64)
                if len(seen) > 62:
                    # signature arithmetic would overflow int64: rehash
                    _, sig = np.unique(sig, return_inverse=True)
    _, byte_class = np.unique(sig, return_inverse=True)
    classes = [np.nonzero(byte_class == c)[0] for c in range(byte_class.max() + 1)]

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset([start]))
    dfa_ids: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = np.full(256, -1, np.int32)
        for cls in classes:
            rep = int(cls[0])
            nxt = set()
            for s in cur:
                for byteset, dst in nfa.edges[s]:
                    if rep in byteset:
                        nxt.add(dst)
            if not nxt:
                continue
            nset = closure(frozenset(nxt))
            if nset not in dfa_ids:
                if len(dfa_ids) >= max_states:
                    raise RegexError(
                        f"DFA exceeds {max_states} states; simplify the "
                        "pattern or raise the limit"
                    )
                dfa_ids[nset] = len(dfa_ids)
                order.append(nset)
            row[cls] = dfa_ids[nset]
        rows.append(row)
    trans = np.stack(rows).astype(np.int32)
    acc = np.array([accept in st for st in order], bool)
    return _minimize(_trim_unproductive(Dfa(trans=trans, accept=acc)))


def _trim_unproductive(dfa: Dfa) -> Dfa:
    """Cut transitions into states from which no accept is reachable.

    Guarantees every reachable state offers SOME continuation (a byte
    transition or EOS-at-accept), which the engine's guided mask relies on:
    a state with nothing allowed would leave a row's logits all -inf.
    Possible sources: degenerate patterns like [^\\x00-\\xff] (empty class)."""
    trans, accept = dfa.trans, dfa.accept
    S = trans.shape[0]
    productive = accept.copy()
    while True:
        reach = productive[np.clip(trans, 0, S - 1)] & (trans >= 0)  # [S,256]
        new = productive | reach.any(axis=1)
        if np.array_equal(new, productive):
            break
        productive = new
    if bool(productive.all()):
        return dfa
    if not productive[0]:
        raise RegexError("pattern matches nothing")
    trans = np.where(
        (trans >= 0) & productive[np.clip(trans, 0, S - 1)], trans, -1
    ).astype(np.int32)
    return Dfa(trans=trans, accept=accept)


def _minimize(dfa: Dfa) -> Dfa:
    """Moore partition refinement. Thompson + subset construction leaves
    many equivalent states (a generic JSON grammar shrinks ~4x), and the
    DFA state count directly sizes the per-slot device tables in
    guided/tokens.py, so minimization pays for itself."""
    trans, accept = dfa.trans, dfa.accept
    S = trans.shape[0]
    labels = accept.astype(np.int64)
    for _ in range(S):
        # signature: own label + the label of each byte-successor
        # (-1 reject successors keep label -1)
        succ = np.where(trans >= 0, labels[np.clip(trans, 0, S - 1)], -1)
        sig = np.concatenate([labels[:, None], succ], axis=1)
        _, new = np.unique(sig, axis=0, return_inverse=True)
        if np.array_equal(new, labels):
            break
        labels = new.astype(np.int64)
    n = int(labels.max()) + 1
    if n == S:
        return dfa
    # representative state per class; start state (0) must stay class... 0
    # is wherever its class lands — remap so class-of-start is index 0
    perm = np.full(n, -1, np.int64)
    order_ids = np.empty(n, np.int64)
    nxt = 0
    for s in range(S):
        c = labels[s]
        if perm[c] < 0:
            perm[c] = nxt
            order_ids[nxt] = s
            nxt += 1
    new_labels = perm[labels]
    rep = order_ids[:n]
    small = trans[rep]                                  # [n, 256]
    small = np.where(small >= 0, new_labels[np.clip(small, 0, S - 1)], -1)
    return Dfa(
        trans=small.astype(np.int32), accept=accept[rep].copy()
    )


def validate_pattern(pattern: str) -> None:
    """Syntax-check a pattern without building the DFA (frontends reject
    malformed grammars as 400s before the request reaches an engine; the
    engine still enforces its own state/class caps at compile time)."""
    _Parser(pattern).parse()


def escape_literal(s: str) -> str:
    """Escape a literal string for embedding in a pattern."""
    out = []
    for ch in s:
        if ch in ".[]{}()*+?|\\^$-":
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        else:
            out.append(ch)
    return "".join(out)
