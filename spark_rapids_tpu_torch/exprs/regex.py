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
"""

from __future__ import annotations

import functools
from typing import FrozenSet, List, NamedTuple, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn

_ANY = np.ones(256, np.bool_)


def _byte_set(b: int) -> np.ndarray:
    s = np.zeros(256, np.bool_)
    s[b] = True
    return s


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


def _to_dfa(nfa: _NFA, start: int, end: int) -> DFA:
    """Subset construction; bytes whose edge memberships are equal form
    one class and are stepped once."""
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
