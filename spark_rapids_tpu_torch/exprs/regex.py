"""SQL LIKE on the device (counterpart of the LIKE part of
spark_rapids_tpu/exprs/regex.py: ``like_to_dfa`` and ``match_strings``).

A LIKE pattern is compiled on the host into a byte-level automaton: the
pattern becomes a Thompson NFA (``%`` a loop over every byte, ``_`` one
byte of any value, every other character its UTF-8 bytes), and subset
construction turns it into a DFA whose bytes with equal transitions share
a column while it is built. The whole string must match, so acceptance is
the state after the row's last byte.

``match_strings`` runs the DFA over a plain string column as torch
operations: one step per byte position up to the longest row (one host
read), each step a gather of every live row's next state from the
(states, 256) transition table. Over a dictionary column the caller runs
it on the dictionary's entries once and gathers the answer by code.

As in the reference, ``_`` matches one byte, so it matches one character
of ASCII text; a pattern that ends with the escape character raises
ValueError on both engines.

RLIKE (counterpart of the reference's regex engine): a subset of Java's
regex syntax is parsed on the host (``_Parser``: literals, ``.``, classes
with ranges and ``\\d\\w\\s`` escapes, groups, alternation, ``* + ?
{n,m}`` with lazy forms, one leading ``^`` and one trailing ``$`` a
branch), built into the same Thompson NFA and DFA, and run by
``match_strings``. Find semantics (Spark's RLIKE is ``Matcher.find``) are
in the automaton: each branch is wrapped as ``.*(branch).*`` minus its
anchored sides (``_find_wrap``), so "matched somewhere" is "the DFA
accepts the row". Back-references, lookaround, boundary matchers, an
interior anchor, possessive quantifiers, POSIX classes, counted repeats
over 64 and a DFA of more than ``spark.rapids.gpu.sql.regex.maxDfaStates``
states raise ``RegexUnsupported``: the planner places such an RLIKE on
the CPU engine, naming the reason. Classes and case are ASCII; ``.``
matches one byte other than ``\\n``, so it counts the bytes of a
multi-byte character (the reference's documented limit).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import FrozenSet, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn

_ANY = np.ones(256, np.bool_)


def _byte_set(b: int) -> np.ndarray:
    s = np.zeros(256, np.bool_)
    s[b] = True
    return s


class RegexUnsupported(Exception):
    """A pattern outside the device's regex subset: the planner places the
    expression on the CPU engine with this reason."""


class DFA(NamedTuple):
    delta: np.ndarray      # int32 (states, 256): next state per byte
    accepting: np.ndarray  # bool (states,)
    start: int


class _NFA:
    """Thompson NFA over bytes: ``trans[s]`` holds (byte set, target)
    edges and ``eps[s]`` the epsilon targets of state ``s``."""

    def __init__(self):
        self.trans: List[List[Tuple[np.ndarray, int]]] = []
        self.eps: List[List[int]] = []

    def state(self) -> int:
        self.trans.append([])
        self.eps.append([])
        return len(self.trans) - 1

    def build(self, node: "Node") -> Tuple[int, int]:
        """The (start, end) states of a syntax tree's fragment."""
        if isinstance(node, Lit):
            a, b = self.state(), self.state()
            self.trans[a].append((node.byteset, b))
            return a, b
        if isinstance(node, Cat):
            a = b = self.state()
            for part in node.parts:
                ps, pe = self.build(part)
                self.eps[b].append(ps)
                b = pe
            return a, b
        if isinstance(node, Alt):
            a, b = self.state(), self.state()
            for part in node.parts:
                ps, pe = self.build(part)
                self.eps[a].append(ps)
                self.eps[pe].append(b)
            return a, b
        if isinstance(node, Rep):
            a, b = self.state(), self.state()
            prev = a
            for _ in range(node.lo):
                ps, pe = self.build(node.child)
                self.eps[prev].append(ps)
                prev = pe
            if node.hi is None:
                ps, pe = self.build(node.child)
                self.eps[prev] += [ps]
                self.eps[pe] += [ps, b]
                self.eps[ps].append(b)
            else:
                self.eps[prev].append(b)
                for _ in range(node.hi - node.lo):
                    ps, pe = self.build(node.child)
                    self.eps[prev].append(ps)
                    self.eps[pe].append(b)
                    prev = pe
            return a, b
        raise RegexUnsupported(f"anchor {node.kind!r} in the middle of a "
                               f"pattern")

    def closure(self, states) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            for t in self.eps[stack.pop()]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)


def _like_parts(pattern: str, escape: str) -> List[object]:
    """The pattern as a list of byte sets (one byte each) and ``"%"``
    (any run of bytes)."""
    parts: List[object] = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape:
            if i + 1 >= len(pattern):
                raise ValueError(f"the LIKE pattern {pattern!r} ends with "
                                 f"the escape character {escape!r}")
            parts.extend(_byte_set(b) for b in pattern[i + 1].encode())
            i += 2
            continue
        if c == "%":
            parts.append("%")
        elif c == "_":
            parts.append(_ANY)
        else:
            parts.extend(_byte_set(b) for b in c.encode())
        i += 1
    return parts


def _to_dfa(nfa: _NFA, start: int, end: int,
            max_states: Optional[int] = None) -> DFA:
    """Subset construction; bytes whose edge memberships are equal form
    one class and are stepped once. Past ``max_states`` states it raises
    RegexUnsupported."""
    edges = [bs for st in nfa.trans for bs, _ in st]
    sig = np.stack(edges, axis=1) if edges else np.zeros((256, 1), np.bool_)
    _, class_of = np.unique(sig, axis=0, return_inverse=True)
    class_of = class_of.reshape(-1)
    reps = [int(np.argmax(class_of == c)) for c in range(class_of.max() + 1)]
    first = nfa.closure([start])
    ids = {first: 0}
    order = [first]
    rows = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = np.zeros(256, np.int32)
        for c, b in enumerate(reps):
            nxt = {t for s in cur for bs, t in nfa.trans[s] if bs[b]}
            closed = nfa.closure(nxt)
            if closed not in ids:
                if max_states is not None and len(ids) >= max_states:
                    raise RegexUnsupported(
                        f"DFA exceeds {max_states} states")
                ids[closed] = len(order)
                order.append(closed)
            row[class_of == c] = ids[closed]
        rows.append(row)
    accepting = np.array([end in st for st in order], np.bool_)
    return DFA(np.stack(rows), accepting, 0)


@functools.lru_cache(maxsize=256)
def like_to_dfa(pattern: str, escape: str = "\\") -> DFA:
    """The DFA of ``x LIKE pattern`` (whole-string match)."""
    nfa = _NFA()
    start = cur = nfa.state()
    for part in _like_parts(pattern, escape):
        if isinstance(part, str):  # "%": loop over any byte
            loop = nfa.state()
            nfa.eps[cur].append(loop)
            nfa.trans[loop].append((_ANY, loop))
            cur = loop
        else:
            nxt = nfa.state()
            nfa.trans[cur].append((part, nxt))
            cur = nxt
    return _to_dfa(nfa, start, cur)


# --------------------------------------------------------------------------
# RLIKE: the Java-regex subset
# --------------------------------------------------------------------------

MAX_COUNTED_REPEAT = 64


@dataclasses.dataclass
class Node:
    pass


@dataclasses.dataclass
class Lit(Node):
    byteset: np.ndarray  # bool (256,)


@dataclasses.dataclass
class Cat(Node):
    parts: List[Node]


@dataclasses.dataclass
class Alt(Node):
    parts: List[Node]


@dataclasses.dataclass
class Rep(Node):
    child: Node
    lo: int
    hi: Optional[int]  # None: unbounded


@dataclasses.dataclass
class Anchor(Node):
    kind: str  # "^" or "$"


def _set_of(*chars: str) -> np.ndarray:
    s = np.zeros(256, np.bool_)
    for c in chars:
        s[ord(c)] = True
    return s


def _range_set(lo: int, hi: int) -> np.ndarray:
    s = np.zeros(256, np.bool_)
    s[lo:hi + 1] = True
    return s


_DIGIT = _range_set(ord("0"), ord("9"))
_WORD = (_range_set(ord("a"), ord("z")) | _range_set(ord("A"), ord("Z"))
         | _DIGIT | _set_of("_"))
_SPACE = _set_of(" ", "\t", "\n", "\x0b", "\f", "\r")
_ANY_BUT_NEWLINE = ~_set_of("\n")
_CLASS_ESCAPES = {"d": _DIGIT, "D": ~_DIGIT, "w": _WORD, "W": ~_WORD,
                  "s": _SPACE, "S": ~_SPACE}
_CHAR_ESCAPES = {"n": "\n", "r": "\r", "t": "\t", "f": "\f", "a": "\a",
                 "e": "\x1b", "0": "\0"}


def _multibyte(c: str) -> Node:
    """A non-ASCII literal: its UTF-8 byte sequence."""
    return Cat([Lit(_range_set(b, b)) for b in c.encode("utf-8")])


class _Parser:
    """Recursive descent over the supported subset (the reference's)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def parse(self) -> Node:
        node = self._alternation()
        if self.i != len(self.p):
            raise RegexUnsupported(f"unbalanced ')' at {self.i} in "
                                   f"{self.p!r}")
        return node

    def _peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def _alternation(self) -> Node:
        parts = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            parts.append(self._concat())
        return parts[0] if len(parts) == 1 else Alt(parts)

    def _concat(self) -> Node:
        parts: List[Node] = []
        while self._peek() not in ("", "|", ")"):
            parts.append(self._repeat())
        return Cat(parts)

    def _repeat(self) -> Node:
        atom = self._atom()
        c = self._peek()
        quantified = True
        if c in ("*", "+", "?"):
            self.i += 1
            atom = Rep(atom, 1 if c == "+" else 0, 1 if c == "?" else None)
        elif c == "{":
            new = self._counted(atom)
            quantified = new is not atom
            atom = new
        else:
            quantified = False
        if quantified:
            nxt = self._peek()
            if nxt == "?":  # lazy: the same set of matches as greedy
                self.i += 1
            elif nxt == "+":  # possessive: no backtracking changes find()
                raise RegexUnsupported("possessive quantifier")
        if isinstance(atom, Rep) and isinstance(atom.child, Anchor):
            raise RegexUnsupported("quantified anchor")
        return atom

    def _counted(self, atom: Node) -> Node:
        j = self.p.find("}", self.i)
        if j < 0:  # Java reads an unmatched '{' as a literal
            return atom
        body = self.p[self.i + 1:j]
        try:
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s.strip() else None
            else:
                lo = hi = int(body)
        except ValueError:
            return atom
        self.i = j + 1
        if lo > MAX_COUNTED_REPEAT or (hi is not None
                                       and hi > MAX_COUNTED_REPEAT):
            raise RegexUnsupported(f"counted repeat too large: {{{body}}}")
        if hi is not None and hi < lo:
            raise RegexUnsupported(f"bad repeat bounds {{{body}}}")
        return Rep(atom, lo, hi)

    def _atom(self) -> Node:
        c = self._peek()
        if c == "(":
            self.i += 1
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            elif self._peek() == "?":
                raise RegexUnsupported(
                    f"group construct (?{self.p[self.i + 1:self.i + 2]}")
            node = self._alternation()
            if self._peek() != ")":
                raise RegexUnsupported("unclosed group")
            self.i += 1
            return node
        if c == "[":
            return self._char_class()
        if c == ".":
            self.i += 1
            return Lit(_ANY_BUT_NEWLINE.copy())
        if c in ("^", "$"):
            self.i += 1
            return Anchor(c)
        if c == "\\":
            return Lit(self._escape())
        if c in ("*", "+", "?"):
            raise RegexUnsupported(f"dangling quantifier {c!r}")
        self.i += 1
        return Lit(_set_of(c)) if ord(c) < 128 else _multibyte(c)

    def _escape(self) -> np.ndarray:
        self.i += 1
        if self.i >= len(self.p):
            raise RegexUnsupported("trailing backslash")
        c = self.p[self.i]
        self.i += 1
        if c in _CLASS_ESCAPES:
            return _CLASS_ESCAPES[c].copy()
        if c in _CHAR_ESCAPES:
            return _set_of(_CHAR_ESCAPES[c])
        if c == "x":
            digits = self.p[self.i:self.i + 2]
            self.i += 2
            try:
                v = int(digits, 16)
            except ValueError:
                raise RegexUnsupported(f"\\x escape \\x{digits!r}") from None
            if v > 0x7F:
                raise RegexUnsupported("non-ASCII \\x escape")
            return _range_set(v, v)
        if c in ("b", "B", "A", "Z", "z", "G"):
            raise RegexUnsupported(f"\\{c} boundary matcher")
        if c.isalnum():  # back-references and every other letter escape
            raise RegexUnsupported(f"unknown escape \\{c}")
        return _set_of(c)

    def _char_class(self) -> Node:
        self.i += 1
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        s = np.zeros(256, np.bool_)
        first = True
        while True:
            c = self._peek()
            if c == "":
                raise RegexUnsupported("unclosed character class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "[" and self.p[self.i:self.i + 2] == "[:":
                raise RegexUnsupported("POSIX class")
            if c == "\\":
                s |= self._escape()
                continue
            self.i += 1
            lo = ord(c)
            if lo > 127:  # a class matches one byte
                raise RegexUnsupported("non-ASCII in class")
            if self._peek() == "-" and self.p[self.i + 1:self.i + 2] not in (
                    "]", ""):
                self.i += 1
                hic = self.p[self.i]
                if hic == "\\":
                    raise RegexUnsupported("escape as range end")
                self.i += 1
                if ord(hic) > 127 or ord(hic) < lo:
                    raise RegexUnsupported("bad class range")
                s |= _range_set(lo, ord(hic))
            else:
                s[lo] = True
        return Lit(~s if negate else s)


def _reject_anchors(node: Node) -> None:
    if isinstance(node, Anchor):
        raise RegexUnsupported("interior anchor")
    for child in getattr(node, "parts", None) or []:
        _reject_anchors(child)
    if isinstance(node, Rep):
        _reject_anchors(node.child)


def _strip_anchors(branch: Node) -> Tuple[Node, bool, bool]:
    """A branch without its one leading ``^`` and one trailing ``$``, and
    whether it had them; any other anchor raises."""
    parts = branch.parts if isinstance(branch, Cat) else [branch]
    at_start = at_end = False
    if parts and isinstance(parts[0], Anchor) and parts[0].kind == "^":
        at_start = True
        parts = parts[1:]
    if parts and isinstance(parts[-1], Anchor) and parts[-1].kind == "$":
        at_end = True
        parts = parts[:-1]
    body = Cat(parts)
    _reject_anchors(body)
    return body, at_start, at_end


def _find_wrap(ast: Node) -> Node:
    """Find semantics as a whole-row match: each branch becomes
    ``.*branch.*`` minus its anchored sides."""
    branches = ast.parts if isinstance(ast, Alt) else [ast]
    wrapped = []
    for br in branches:
        body, at_start, at_end = _strip_anchors(br)
        parts: List[Node] = []
        if not at_start:
            parts.append(Rep(Lit(_ANY.copy()), 0, None))
        parts.append(body)
        if not at_end:
            parts.append(Rep(Lit(_ANY.copy()), 0, None))
        wrapped.append(Cat(parts))
    return wrapped[0] if len(wrapped) == 1 else Alt(wrapped)


def _max_states() -> int:
    from spark_rapids_tpu_torch.config import conf as C

    return C.REGEX_MAX_DFA_STATES.get(C.get_active())


def _compile(ast: Node, max_states: int) -> DFA:
    nfa = _NFA()
    start, end = nfa.build(ast)
    return _to_dfa(nfa, start, end, max_states)


@functools.lru_cache(maxsize=256)
def _compile_rlike(pattern: str, max_states: int) -> DFA:
    return _compile(_find_wrap(_Parser(pattern).parse()), max_states)


def compile_rlike(pattern: str, max_states: Optional[int] = None) -> DFA:
    """The DFA of ``x RLIKE pattern`` (find semantics) with at most
    ``max_states`` states (the active conf's
    ``spark.rapids.gpu.sql.regex.maxDfaStates`` by default); raises
    RegexUnsupported outside the subset."""
    return _compile_rlike(pattern, max_states or _max_states())


def compile_fullmatch(pattern: str, max_states: Optional[int] = None
                      ) -> DFA:
    """The DFA of a whole-row match of ``pattern`` (``^``/``$`` at a
    branch's ends are no-ops)."""
    ast = _Parser(pattern).parse()
    branches = ast.parts if isinstance(ast, Alt) else [ast]
    bodies = [_strip_anchors(br)[0] for br in branches]
    return _compile(bodies[0] if len(bodies) == 1 else Alt(bodies),
                    max_states or _max_states())


def match_strings(dfa: DFA, col: DeviceColumn) -> torch.Tensor:
    """Per row of a plain string column: whether the DFA accepts the
    row's bytes (bool). Null rows hold empty strings; the caller masks
    them with the column's validity."""
    dev = col.device
    n = col.num_rows
    delta = torch.from_numpy(dfa.delta.astype(np.int64)).to(dev)
    accepting = torch.from_numpy(dfa.accepting).to(dev)
    state = torch.full((n,), dfa.start, dtype=torch.int64, device=dev)
    if n == 0 or col.data.numel() == 0:
        return accepting[state]
    lens = col.lengths().long()
    starts = col.offsets[:-1].long()
    limit = col.data.numel() - 1
    data = col.data.long()
    for k in range(int(lens.max())):
        live = lens > k
        byte = data[torch.clamp(starts + k, max=limit)]
        state = torch.where(live, delta[state, byte], state)
    return accepting[state]
