"""get_json_object on the device: a byte-level JSON scanner of whole-column
passes (counterpart of spark_rapids_tpu/exprs/json_device.py).

The structure of every row is found in a few passes over the column's
flat bytes: escaped bytes from the runs of backslashes (the last byte
that is not one, ``_last_marked``: a ``torch.cumsum`` of the marks and a
gather of their positions), string mode from the parity of the
unescaped quotes before a byte (``torch.cumsum``), the bracket depth
(``torch.cumsum`` of opens minus closes) and the previous non-whitespace
byte (``_last_marked``). Each step of the path then narrows a per-row
``[lo, hi)`` byte range by the first marked byte at or after ``lo``
(``torch.searchsorted`` of the rows' ``lo`` in the marked positions):
a key is a quote at the next depth after ``{`` or
``,`` spelling the key, followed by ``"`` and a ``:``; an index counts the
commas at the next depth. No per-row loop.

The result follows the reference's: a string unquoted with ``\\"``,
``\\\\`` and ``\\/`` unescaped and the control escapes ``\\n \\t \\r \\b
\\f`` substituted, true, false and numbers as text, a container with its
structural whitespace removed; JSON null, a missing path and a lookup in
something that is not a container give SQL NULL. Its differences from its
CPU oracle stay: a ``\\uXXXX`` escape is not decoded (its backslash is
dropped, as every escape's, and its digits kept), and a number keeps its
text (``1.50`` stays ``1.50``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exprs.strings import make_offsets, row_ids

Step = Tuple[str, Union[bytes, int]]


def parse_path(path: str) -> Optional[List[Step]]:
    """The steps of a path of ``$``, ``.name``, ``['name']`` and
    ``[index]``; None when the path is outside that grammar."""
    if not path.startswith("$"):
        return None
    steps: List[Step] = []
    i = 1
    while i < len(path):
        if path[i] == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            key = path[i + 1: j]
            if not key or '"' in key or "\\" in key:
                return None
            steps.append(("key", key.encode()))
            i = j
        elif path[i] == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            tok = path[i + 1: j]
            if tok[:1] in ("'", '"'):
                if len(tok) < 2 or tok[-1] != tok[0]:
                    return None
                steps.append(("key", tok[1:-1].encode()))
            else:
                try:
                    steps.append(("index", int(tok)))
                except ValueError:
                    return None
            i = j + 1
        else:
            return None
    return steps


def _last_marked(mask: torch.Tensor) -> torch.Tensor:
    """The last position at or before each position where ``mask`` is
    set, -1 before the first: the marked positions gathered by the count
    of marks so far (a ``cumsum``, where ``torch.cummax`` costs far more on
    the card)."""
    pos = torch.nonzero(mask).squeeze(1).int()
    if pos.numel() == 0:
        return torch.full(mask.shape, -1, dtype=torch.int32,
                          device=mask.device)
    c = torch.cumsum(mask, 0, dtype=torch.int32)
    return torch.where(c > 0, pos[(c - 1).clamp(min=0)], -1)


def _shift(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` moved one place on, ``fill`` first."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype,
                                 device=x.device), x[:-1]])


class Structure(NamedTuple):
    """A column's JSON structure, one value a byte (int32 positions), the
    same for every path: read once for all the paths of a projection."""

    j: torch.Tensor            # the byte's position
    rows: torch.Tensor         # its row
    starts: torch.Tensor       # each row's first byte (n,)
    ends: torch.Tensor         # each row's end (n,)
    row_end: torch.Tensor      # its row's end, a byte
    bs: torch.Tensor           # a backslash
    escaped: torch.Tensor      # escaped by an odd run of backslashes
    quote: torch.Tensor        # an unescaped quote
    struct: torch.Tensor       # outside strings, not a quote
    depth_after: torch.Tensor  # bracket depth after the byte
    depth_before: torch.Tensor
    ws: torch.Tensor           # structural whitespace
    pnw: torch.Tensor          # the last non-whitespace position <= j
    prev_nonws: torch.Tensor   # the last one < j in its row, else -1


def structure(sv: DeviceColumn) -> Structure:
    data, offsets = sv.data, sv.offsets
    nbytes, dev = data.numel(), sv.device
    i32 = torch.int32
    j = torch.arange(nbytes, dtype=i32, device=dev)
    rows = row_ids(offsets, nbytes)
    starts, ends = offsets[:-1], offsets[1:]
    row_start, row_end = starts[rows], ends[rows]
    minus1 = torch.full_like(j, -1)
    # escapes and string mode
    bs = data == ord("\\")
    lastnb = torch.maximum(_last_marked(~bs), row_start - 1)  # in a row
    runlen = j - lastnb  # the backslashes ending at a byte
    escaped = (_shift(runlen, 0) * _shift(bs, False)) % 2 == 1
    quote = (data == ord('"')) & ~escaped
    qcs = torch.cumsum(quote, 0, dtype=i32)
    q_before = (qcs - quote.int()) - (qcs[row_start] - quote[row_start].int())
    struct = (q_before % 2 == 0) & ~quote
    # depth
    opens = struct & ((data == ord("{")) | (data == ord("[")))
    closes = struct & ((data == ord("}")) | (data == ord("]")))
    delta = opens.int() - closes.int()
    dcs = torch.cumsum(delta, 0, dtype=i32)
    depth_after = dcs - (dcs[row_start] - delta[row_start])
    # whitespace and the previous non-whitespace byte of the row
    ws = struct & ((data == ord(" ")) | (data == ord("\t"))
                   | (data == ord("\n")) | (data == ord("\r")))
    pnw = _last_marked(~ws)
    prev = _shift(pnw, -1)
    prev_nonws = torch.where(prev >= row_start, prev, minus1)
    return Structure(j, rows, starts, ends, row_end, bs, escaped, quote,
                     struct, depth_after, depth_after - delta, ws, pnw,
                     prev_nonws)


def get_json_object(sv: DeviceColumn, path: str,
                    st: Optional[Structure] = None) -> DeviceColumn:
    """The value at ``path`` of each row of a plain string column
    (``st``: its ``structure``, when the caller has it)."""
    steps = parse_path(path)
    if steps is None:
        raise NotImplementedError(f"json path {path!r} not on device")
    data = sv.data
    n, nbytes, dev = sv.num_rows, data.numel(), sv.device
    if nbytes == 0:
        return DeviceColumn(T.STRING, data, torch.zeros_like(sv.validity),
                            torch.zeros(n + 1, dtype=torch.int32,
                                        device=dev))
    st = st or structure(sv)
    (j, rows, starts, row_end_r, row_end, bs, escaped, quote, struct,
     depth_after, depth_before, ws, pnw, prev_nonws) = st
    nonws = ~ws
    big = torch.full((n,), nbytes, dtype=torch.int32, device=dev)

    def at(pos: torch.Tensor) -> torch.Tensor:
        return data[pos.clamp(0, nbytes - 1)]

    def seg_min_where(mask, lo, hi):
        """Per row, the least position in [lo, hi) under ``mask``;
        ``nbytes`` when there is none: the first marked position at or
        after ``lo`` (a binary search of the marked positions), if it is
        before ``hi``."""
        pos = torch.nonzero(mask).squeeze(1).int()
        if pos.numel() == 0:
            return big
        k = torch.searchsorted(pos, lo.int())
        at_lo = pos[k.clamp(max=pos.numel() - 1)]
        return torch.where((k < pos.numel()) & (at_lo < hi), at_lo, big)

    def seg_min(mask: torch.Tensor) -> torch.Tensor:
        return seg_min_where(mask, starts, row_end_r)

    lo = seg_min(nonws)
    ok = sv.validity & (lo < nbytes)
    hi = row_end_r
    base = torch.zeros(n, dtype=torch.int32, device=dev)
    for kind, arg in steps:
        nb = base[rows] + 1  # the depth of this step's members
        if kind == "key":
            key = list(arg)
            k = len(key)
            prev_ch = at(prev_nonws)
            cand = (quote & (depth_before == nb) & (prev_nonws >= 0)
                    & ((prev_ch == ord("{")) | (prev_ch == ord(","))))
            # spell the key only at the candidate quotes (one host read)
            q = torch.nonzero(cand).squeeze(1)
            q_end = row_end[q]
            spelt = (quote[(q + 1 + k).clamp(0, nbytes - 1)]
                     & (q + 1 + k < q_end))
            for i2, ch in enumerate(key):
                spelt = spelt & (at(q + 1 + i2) == ch)
            cand = torch.zeros_like(cand).index_fill_(0, q[spelt], True)
            p = seg_min_where(cand, lo, hi)
            p_c = p.clamp(0, nbytes - 1)
            colon = seg_min_where(nonws, p_c + k + 2, row_end_r)
            found = (p < nbytes) & (colon < nbytes) & (at(colon) == ord(":"))
            vstart = seg_min_where(nonws, colon.clamp(0, nbytes - 1) + 1,
                                   row_end_r)
            ends = struct & (((data == ord(",")) & (depth_before == nb))
                             | ((data == ord("}"))
                                & (depth_after == base[rows])))
        else:
            lo_c = lo.clamp(0, nbytes - 1)
            is_arr = data[lo_c] == ord("[")
            seps = struct & (data == ord(",")) & (depth_before == nb)
            scs = torch.cumsum(seps & (j >= lo[rows]) & (j < hi[rows]), 0,
                               dtype=torch.int32)
            total = torch.where(hi > lo + 1,
                                scs[(hi - 1).clamp(0, nbytes - 1)]
                                - scs[lo_c], torch.zeros_like(hi))
            first_inner = seg_min_where(nonws, lo_c + 1, hi)
            empty = (first_inner < nbytes) & (at(first_inner) == ord("]"))
            n_elems = torch.where(empty, torch.zeros_like(total), total + 1)
            idx = (n_elems + arg if arg < 0
                   else torch.full_like(n_elems, arg))
            found = is_arr & (idx >= 0) & (idx < n_elems)
            kth = (seps & (j >= lo[rows]) & (j < hi[rows])
                   & ((scs - scs[lo_c][rows]) == idx[rows]))
            sep_pos = seg_min_where(kth, lo, hi)
            estart = torch.where(idx == 0, lo + 1,
                                 sep_pos.clamp(0, nbytes - 1) + 1)
            vstart = seg_min_where(nonws, estart, row_end_r)
            ends = struct & (((data == ord(",")) & (depth_before == nb))
                             | ((data == ord("]"))
                                & (depth_after == base[rows])))
        vend = seg_min_where(ends, vstart.clamp(0, nbytes - 1), hi)
        ok = ok & found & (vstart < nbytes) & (vend < nbytes)
        lo = vstart.clamp(0, nbytes - 1)
        hi = vend.clamp(0, nbytes)
        base = base + 1

    # trim the range's trailing whitespace: the last non-whitespace
    # position before hi (``pnw``), if it is at or after lo
    last = pnw[(hi - 1).clamp(0, nbytes - 1)]
    hi = torch.where((hi > lo) & (last >= lo), last + 1, lo)
    ok = ok & (hi > lo)

    # JSON null is SQL NULL; a string loses its quotes and escapes
    is_string = at(lo) == ord('"')
    is_null = hi - lo == 4
    for i2, ch in enumerate(b"null"):
        is_null = is_null & (at(lo + i2) == ch)
    ok = ok & ~is_null
    in_sel = (j >= lo[rows]) & (j < hi[rows]) & ok[rows]
    sel_str = is_string[rows]
    esc_bs = bs & ~escaped  # a backslash that starts an escape pair
    drop = sel_str & ((j == lo[rows]) | (j == hi[rows] - 1) | esc_bs)
    drop = drop | (~sel_str & ws)
    keep = in_sel & ~drop
    after_esc = _shift(sel_str & esc_bs, False)
    sub = data
    for src_ch, dst_ch in ((ord("n"), 10), (ord("t"), 9), (ord("r"), 13),
                           (ord("b"), 8), (ord("f"), 12)):
        sub = torch.where(after_esc & (data == src_ch),
                          torch.full_like(sub, dst_ch), sub)
    lens = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, rows, keep.int())
    # kept bytes stay in row order, so each row's land in its own range
    return DeviceColumn(T.STRING, sub[keep], sv.validity & ok,
                        make_offsets(lens))
