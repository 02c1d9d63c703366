"""Regex -> byte-level DFA, the substrate for grammar-guided decoding.

The port's copy of ``qspec_tpu/guided/regex_dfa.py``, in place of the
reference's outlines/lm-format-enforcer/xgrammar integration
(vllm/model_executor/guided_decoding/*.py): instead of host-side logits
processors that walk an automaton per step, the pattern compiles to a dense
DFA whose token-level transition table lives on the device (see
tokenfsm.py) and advances inside the decode and verify rounds.

Supported syntax (the subset outlines' JSON-schema compiler emits, which is
what serving needs): literals, ``.``, escapes (\\d \\w \\s \\D \\W \\S and
escaped punctuation), character classes ``[a-z0-9_]`` / ``[^...]``, groups
``(...)``, alternation ``|``, quantifiers ``* + ? {m} {m,} {m,n}``.
Operates on UTF-8 bytes, so multi-byte characters work unmodified.

Construction: recursive-descent parse -> Thompson NFA -> subset-construction
DFA over the 256-byte alphabet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

_META = set("\\.[](){}|*+?")


def _class_escape(ch: str) -> Set[int]:
    """Bytes matched by an escape sequence."""
    if ch == "d":
        return set(range(0x30, 0x3A))
    if ch == "D":
        return set(range(256)) - set(range(0x30, 0x3A))
    if ch == "w":
        w = set(range(0x30, 0x3A)) | set(range(0x41, 0x5B)) | \
            set(range(0x61, 0x7B)) | {0x5F}
        return w
    if ch == "W":
        return set(range(256)) - _class_escape("w")
    if ch == "s":
        return {0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C}
    if ch == "S":
        return set(range(256)) - _class_escape("s")
    if ch == "n":
        return {0x0A}
    if ch == "t":
        return {0x09}
    if ch == "r":
        return {0x0D}
    # escaped literal (punctuation, \\, etc.) — may be multi-byte
    bs = ch.encode("utf-8")
    if len(bs) != 1:
        raise ValueError(f"escaped multi-byte char {ch!r} unsupported in class")
    return {bs[0]}


# ---------------------------------------------------------------- NFA

@dataclass
class _NFAState:
    # byte -> set of next states; eps edges separate
    edges: Dict[int, Set[int]] = field(default_factory=dict)
    eps: Set[int] = field(default_factory=set)


class _NFA:
    def __init__(self):
        self.states: List[_NFAState] = []

    def new(self) -> int:
        self.states.append(_NFAState())
        return len(self.states) - 1

    def add(self, s: int, byte: int, t: int):
        self.states[s].edges.setdefault(byte, set()).add(t)

    def add_eps(self, s: int, t: int):
        self.states[s].eps.add(t)


# fragment = (start, accept) state pair
Frag = Tuple[int, int]


class _Parser:
    """Recursive descent over the pattern; builds NFA fragments."""

    def __init__(self, pattern: str, nfa: _NFA):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> Frag:
        frag = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return frag

    def _alt(self) -> Frag:
        frags = [self._concat()]
        while self._peek() == "|":
            self._next()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, a = self.nfa.new(), self.nfa.new()
        for fs, fa in frags:
            self.nfa.add_eps(s, fs)
            self.nfa.add_eps(fa, a)
        return s, a

    def _concat(self) -> Frag:
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.new()
            return s, s
        for (_, a1), (s2, _) in zip(frags, frags[1:]):
            self.nfa.add_eps(a1, s2)
        return frags[0][0], frags[-1][1]

    def _repeat(self) -> Frag:
        frag = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self._next()
                frag = self._star(frag)
            elif ch == "+":
                self._next()
                frag = self._plus(frag)
            elif ch == "?":
                self._next()
                frag = self._opt(frag)
            elif ch == "{":
                frag = self._bounded(frag)
            else:
                return frag

    def _snapshot(self):
        return self.i

    def _star(self, frag: Frag) -> Frag:
        s, a = self.nfa.new(), self.nfa.new()
        fs, fa = frag
        self.nfa.add_eps(s, fs)
        self.nfa.add_eps(s, a)
        self.nfa.add_eps(fa, fs)
        self.nfa.add_eps(fa, a)
        return s, a

    def _plus(self, frag: Frag) -> Frag:
        fs, fa = frag
        a = self.nfa.new()
        self.nfa.add_eps(fa, a)
        self.nfa.add_eps(a, fs)
        return fs, a

    def _opt(self, frag: Frag) -> Frag:
        s, a = self.nfa.new(), self.nfa.new()
        fs, fa = frag
        self.nfa.add_eps(s, fs)
        self.nfa.add_eps(fa, a)
        self.nfa.add_eps(s, a)
        return s, a

    def _bounded(self, frag: Frag) -> Frag:
        """{m}, {m,}, {m,n}: re-parse the atom text to duplicate it (an NFA
        fragment can't be cloned cheaply, but re-parsing the same source
        builds fresh states)."""
        # find the atom source: we need its span. Track by re-parsing from
        # a recorded start (set in _atom). The parser records spans.
        atom_start = self._last_atom_start
        atom_src = self.p[atom_start:self.i]
        assert self._peek() == "{"
        self._next()
        spec = ""
        while self._peek() not in (None, "}"):
            spec += self._next()
        if self._peek() != "}":
            raise ValueError("unterminated {}")
        self._next()
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            lo = int(lo_s) if lo_s else 0
            hi = int(hi_s) if hi_s.strip() else None
        else:
            lo = hi = int(spec)
        if hi is not None and hi < lo:
            raise ValueError(f"bad bound {{{spec}}}")
        if hi is not None and hi > 256:
            raise ValueError("quantifier bound too large (>256)")

        def clone() -> Frag:
            sub = _Parser(atom_src, self.nfa)
            f = sub.parse()
            return f

        parts: List[Frag] = [frag] if lo >= 1 else []
        for _ in range(max(lo - 1, 0)):
            parts.append(clone())
        opt_parts: List[Frag] = []
        if hi is None:
            star_body = frag if lo == 0 else clone()
            opt_parts.append(self._star(star_body))
        else:
            base = frag if lo == 0 else None
            for j in range(hi - lo):
                opt_parts.append(self._opt(base if (base is not None and j == 0)
                                           else clone()))
        allp = parts + opt_parts
        if not allp:
            s = self.nfa.new()
            return s, s
        for (_, a1), (s2, _) in zip(allp, allp[1:]):
            self.nfa.add_eps(a1, s2)
        return allp[0][0], allp[-1][1]

    def _atom(self) -> Frag:
        start = self.i
        ch = self._next()
        if ch == "(":
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError("unbalanced (")
            self._next()
        elif ch == "[":
            frag = self._char_class()
        elif ch == ".":
            frag = self._bytes(set(range(256)) - {0x0A})
        elif ch == "\\":
            frag = self._bytes(self._escape_set())
        elif ch in "*+?{":
            raise ValueError(f"dangling quantifier {ch!r}")
        else:
            frag = self._literal(ch)
        # span of THIS atom, for {m,n} re-parse cloning (inner atoms of a
        # group overwrite it while parsing; restore on exit)
        self._last_atom_start = start
        return frag

    def _literal(self, ch: str) -> Frag:
        bs = ch.encode("utf-8")
        s = self.nfa.new()
        cur = s
        for b in bs:
            nxt = self.nfa.new()
            self.nfa.add(cur, b, nxt)
            cur = nxt
        return s, cur

    def _bytes(self, byteset: Set[int]) -> Frag:
        s, a = self.nfa.new(), self.nfa.new()
        for b in byteset:
            self.nfa.add(s, b, a)
        return s, a

    def _escape_set(self) -> Set[int]:
        """Bytes for the escape following a consumed backslash; handles
        \\xHH hex escapes (the JSON-schema STRING pattern uses them)."""
        ch = self._next()
        if ch == "x":
            hex2 = self._next() + self._next()
            return {int(hex2, 16)}
        return _class_escape(ch)

    def _class_item(self):
        """One class element: ('byte', b) for a single byte (range-capable)
        or ('set', bytes) for multi-byte escapes like \\d."""
        ch = self._next()
        if ch == "\\":
            s = self._escape_set()
            if len(s) == 1:
                return ("byte", next(iter(s)))
            return ("set", s)
        bs = ch.encode("utf-8")
        if len(bs) == 1:
            return ("byte", bs[0])
        raise ValueError("multi-byte char in class unsupported")

    def _char_class(self) -> Frag:
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        byteset: Set[int] = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise ValueError("unterminated [")
            if ch == "]" and not first:
                self._next()
                break
            first = False
            kind, val = self._class_item()
            if kind == "set":
                byteset |= val
                continue
            # range?
            if self._peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                self._next()  # consume '-'
                kind2, hi = self._class_item()
                if kind2 != "byte":
                    raise ValueError("class-set escape can't end a range")
                byteset |= set(range(val, hi + 1))
            else:
                byteset.add(val)
        if negate:
            byteset = set(range(256)) - byteset
        return self._bytes(byteset)


# ---------------------------------------------------------------- DFA

class ByteDFA:
    """Dense DFA: table [S, 256] int32 next-state (-1 = dead), accepting
    [S] bool, start state 0."""

    def __init__(self, table: np.ndarray, accepting: np.ndarray):
        self.table = table
        self.accepting = accepting

    @property
    def num_states(self) -> int:
        return self.table.shape[0]

    def matches(self, s: str) -> bool:
        cur = 0
        for b in s.encode("utf-8"):
            cur = int(self.table[cur, b])
            if cur < 0:
                return False
        return bool(self.accepting[cur])


def compile_regex(pattern: str) -> ByteDFA:
    nfa = _NFA()
    start, accept = _Parser(pattern, nfa).parse()

    def eclose(states: FrozenSet[int]) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.states[s].eps:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eclose(frozenset({start}))
    dfa_ids: Dict[FrozenSet[int], int] = {start_set: 0}
    work = [start_set]
    rows: List[np.ndarray] = []
    acc: List[bool] = []
    while work:
        cur = work.pop()
        # ensure row list aligned with ids: process in id order via dict
        row = np.full(256, -1, np.int32)
        moved: Dict[int, Set[int]] = {}
        for s in cur:
            for b, ts in nfa.states[s].edges.items():
                moved.setdefault(b, set()).update(ts)
        for b, ts in moved.items():
            tgt = eclose(frozenset(ts))
            if tgt not in dfa_ids:
                dfa_ids[tgt] = len(dfa_ids)
                work.append(tgt)
            row[b] = dfa_ids[tgt]
        idx = dfa_ids[cur]
        while len(rows) <= idx:
            rows.append(None)  # type: ignore
            acc.append(False)
        rows[idx] = row
        acc[idx] = accept in cur
    table = np.stack(rows).astype(np.int32)
    if table.shape[0] > 8192:
        raise ValueError(f"DFA too large ({table.shape[0]} states)")
    return ByteDFA(table, np.asarray(acc, bool))
